"""Stream validation: bounds-checked structural walk with diagnostics.

The port's own copy of ``sprintz_tpu/validate.py`` (the CLI's ``info``
calls it); it runs on the host and needs no device.

The reference decoder trusts metadata completely (format.h:47-62;
SURVEY §5 "failure detection: none"). This validator walks a stream with
explicit bounds checks so corrupt/truncated inputs are diagnosed instead
of decoding garbage — useful before shipping bytes into the trusting
fast-path decoders.
"""

from __future__ import annotations

import dataclasses

from .constants import (
    BLOCK_SZ,
    GROUP_SZ_BLOCKS,
    LOWDIM_MAX_NDIMS,
    METADATA_LEN_RLE,
    MIN_DATA_SIZE,
    nbits_sz_bits,
)
from .stream_format import read_metadata_rle


@dataclasses.dataclass
class ValidationReport:
    ok: bool
    ndims: int = 0
    ngroups: int = 0
    total_rows: int = 0
    data_blocks: int = 0
    run_blocks: int = 0
    stream_bytes: int = 0
    errors: list[str] = dataclasses.field(default_factory=list)


def validate_stream(buf: bytes, elem_sz: int = 1) -> ValidationReport:
    """Structurally validate a compressed stream without decoding payloads."""
    rep = ValidationReport(ok=False, stream_bytes=len(buf))
    if len(buf) < METADATA_LEN_RLE:
        rep.errors.append(
            f"buffer ({len(buf)}B) shorter than the 8-byte metadata")
        return rep
    ngroups, remaining_len, ndims = read_metadata_rle(buf)
    rep.ngroups, rep.ndims = ngroups, ndims

    if ngroups == 0:
        if remaining_len >= MIN_DATA_SIZE:
            rep.errors.append(
                f"ngroups=0 but remaining_len={remaining_len} >= "
                f"{MIN_DATA_SIZE} (verbatim streams must be shorter)")
        need = METADATA_LEN_RLE + remaining_len * elem_sz
        if len(buf) < need:
            rep.errors.append(
                f"verbatim body truncated: have {len(buf)}B, need {need}B")
        rep.ok = not rep.errors
        return rep

    if ndims == 0:
        rep.errors.append("ndims=0 with ngroups>0")
        return rep
    lowdim = ndims <= LOWDIM_MAX_NDIMS[elem_sz]
    hdr_bits = nbits_sz_bits(elem_sz)
    elem_bits = 8 * elem_sz
    total_header_bytes = (ndims * hdr_bits * GROUP_SZ_BLOCKS + 7) // 8

    pos = METADATA_LEN_RLE
    for g in range(ngroups):
        if pos + total_header_bytes > len(buf):
            rep.errors.append(
                f"group {g}: header region at {pos} exceeds buffer")
            return rep
        header_acc = int.from_bytes(buf[pos : pos + total_header_bytes],
                                    "little")
        pos += total_header_bytes
        bitpos = 0
        for b in range(GROUP_SZ_BLOCKS):
            wsum = 0
            for d in range(ndims):
                h = (header_acc >> (bitpos + d * hdr_bits)) & (
                    (1 << hdr_bits) - 1)
                w = elem_bits if h == elem_bits - 1 else h
                if not lowdim and elem_sz == 1 and w == 7:
                    rep.errors.append(
                        f"group {g} block {b} dim {d}: illegal width 7 in "
                        f"the row-major 8-bit format")
                wsum += w
            bitpos += ndims * hdr_bits
            if wsum == 0:
                if pos >= len(buf):
                    rep.errors.append(
                        f"group {g} block {b}: run varint at {pos} exceeds "
                        f"buffer")
                    return rep
                low = buf[pos]
                pos += 1
                length = low & 0x7F
                if low & 0x80:
                    if pos >= len(buf):
                        rep.errors.append(
                            f"group {g} block {b}: truncated 2-byte varint")
                        return rep
                    length |= buf[pos] << 7
                    pos += 1
                rep.total_rows += length * BLOCK_SZ
                rep.run_blocks += 1
            else:
                nbytes = wsum if lowdim else BLOCK_SZ * ((wsum + 7) // 8)
                if pos + nbytes > len(buf):
                    rep.errors.append(
                        f"group {g} block {b}: payload [{pos}, "
                        f"{pos + nbytes}) exceeds buffer ({len(buf)}B)")
                    return rep
                pos += nbytes
                rep.total_rows += BLOCK_SZ
                rep.data_blocks += 1
    need = pos + remaining_len * elem_sz
    if len(buf) < need:
        rep.errors.append(
            f"verbatim tail truncated: have {len(buf)}B, need {need}B")
    rep.ok = not rep.errors
    return rep
