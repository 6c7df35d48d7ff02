"""Seekable streams: checkpoint sidecars for mid-stream and chunk-parallel
decode.

Counterpart of ``sprintz_tpu/checkpoint.py``, with its byte format. The
stream format records no forecaster state, so a decode replays the stream
from its start; a *sidecar* records, every ``every_groups`` groups, the
group's byte offset, its first row and the forecaster state entering it
(delta: the previous row; FIRE: prev value, prev delta, learning counter).
With it a stream decodes from any checkpoint (``decode_range``), and a
whole stream decodes chunk-parallel (``decompress_parallel``): each chunk
enters at its recorded state, so FIRE's serial chain spans one chunk (16
groups, 32 blocks or more with runs) instead of the stream.

The port builds the sidecar from the encode it runs anyway: the assembler
gives every group's byte offset and first row, and FIRE's encode launch
writes its carry before every block, of which the checkpoints' are
gathered on the device. The chunk-parallel decode walks the sidecar's
segments on host threads and decodes the stream's whole block timeline in
one device pass, each chunk from its state (``decoder.decode_device`` with
``chunks``), so the values come out in order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import decoder, encoder
from .constants import (
    BLOCK_SZ,
    GROUP_SZ_BLOCKS,
    LOWDIM_MAX_NDIMS,
    METADATA_LEN_RLE,
    nbits_sz_bits,
)
from .device import resolve_device
from .errors import CorruptStreamError
from .ops.bitmath import header_to_width
from .planner import unpack_headers
from .stream_format import read_metadata_rle


@dataclasses.dataclass
class Sidecar:
    every_groups: int
    codec: str
    elem_sz: int
    ndims: int
    byte_offsets: np.ndarray  # (nckpt,) group start offsets into the stream
    row_offsets: np.ndarray  # (nckpt,) first output row of the group
    states: np.ndarray  # (nckpt, state_dim, ndims) int32

    def to_bytes(self) -> bytes:
        head = np.array(
            [self.every_groups, {"delta": 0, "xff": 1}[self.codec],
             self.elem_sz, self.ndims, len(self.byte_offsets)],
            dtype=np.int64).tobytes()
        return (head + self.byte_offsets.astype(np.int64).tobytes()
                + self.row_offsets.astype(np.int64).tobytes()
                + self.states.astype(np.int32).tobytes())

    @classmethod
    def from_bytes(cls, buf: bytes) -> "Sidecar":
        head = np.frombuffer(buf, dtype=np.int64, count=5)
        every, codec_id, elem_sz, ndims, n = (int(v) for v in head)
        codec = "delta" if codec_id == 0 else "xff"
        off = 40
        bo = np.frombuffer(buf, dtype=np.int64, count=n, offset=off)
        off += 8 * n
        ro = np.frombuffer(buf, dtype=np.int64, count=n, offset=off)
        off += 8 * n
        sdim = 1 if codec == "delta" else 3
        st = np.frombuffer(buf, dtype=np.int32, count=n * sdim * ndims,
                           offset=off).reshape(n, sdim, ndims)
        return cls(every, codec, elem_sz, ndims, bo.copy(), ro.copy(),
                   st.copy())


def compress_with_sidecar(
    flat: np.ndarray,
    ndims: int,
    codec: str = "delta",
    every_groups: int = 16,
    device: str | torch.device | None = None,
) -> tuple[bytes, Sidecar]:
    """Encode (the bytes of ``encoder.compress``) and build a checkpoint
    sidecar with a checkpoint every ``every_groups`` groups, the JAX
    package's default of 16 (its chunk-parallel decode then runs 32
    blocks a chunk on run-free streams)."""
    flat = np.ascontiguousarray(flat).reshape(-1)
    elem_sz = flat.dtype.itemsize
    stream, layout = encoder.compress_with_layout(
        flat, ndims, codec=codec, elem_sz=elem_sz, device=device,
        fire_states=codec == "xff")
    ck = np.arange(0, layout.group_offsets.size, every_groups)
    first_block = layout.group_first_rows[ck] // BLOCK_SZ
    if codec == "delta":
        # the previous row (zeros at the stream's start)
        rows = flat[: layout.nb * BLOCK_SZ * ndims].reshape(-1, ndims)
        states = np.zeros((ck.size, 1, ndims), dtype=np.int32)
        later = first_block > 0
        states[later, 0] = rows[first_block[later] * BLOCK_SZ - 1]
    elif ck.size:
        # FIRE's carry before each checkpoint's first block, gathered on
        # the device from the encode's (nb, 3, D) carries
        carries = layout.fire_states
        at = torch.from_numpy(np.minimum(first_block, layout.nb - 1)).to(
            carries.device)
        states = carries[at].cpu().numpy().astype(np.int32)
        states[first_block == 0] = 0
    else:
        states = np.zeros((0, 3, ndims), dtype=np.int32)
    return stream, Sidecar(
        every_groups=every_groups, codec=codec, elem_sz=elem_sz, ndims=ndims,
        byte_offsets=layout.group_offsets[ck],
        row_offsets=layout.group_first_rows[ck], states=states)


def _group_index_py(buf: bytes, ngroups: int, ndims: int, elem_sz: int,
                    lowdim: bool = False):
    """The plain version of the assembler's group index: a Python walk over
    every group, the JAX package's ``checkpoint._group_index`` ->
    (byte offsets, first rows, first blocks) of the groups, int64, and
    the rows they cover."""
    hdr_bits = nbits_sz_bits(elem_sz)
    total_header_bytes = (ndims * hdr_bits * GROUP_SZ_BLOCKS + 7) // 8
    data = np.frombuffer(buf, dtype=np.uint8)
    offs = np.zeros(ngroups, dtype=np.int64)
    rows = np.zeros(ngroups, dtype=np.int64)
    blocks = np.zeros(ngroups, dtype=np.int64)
    pos, row, blk = METADATA_LEN_RLE, 0, 0
    for g in range(ngroups):
        offs[g], rows[g], blocks[g] = pos, row, blk
        hdr = unpack_headers(
            data[pos: pos + total_header_bytes][None, :], 1, ndims, hdr_bits)
        pos += total_header_bytes
        for w in header_to_width(hdr.astype(np.int64), 8 * elem_sz):
            wsum = int(w.sum())
            if wsum == 0:
                low = buf[pos]
                pos += 1
                length = low & 0x7F
                if low & 0x80:
                    length |= buf[pos] << 7
                    pos += 1
                row += length * BLOCK_SZ
                blk += length
            else:
                pos += wsum if lowdim else BLOCK_SZ * ((wsum + 7) // 8)
                row += BLOCK_SZ
                blk += 1
    return offs, rows, blocks, row


def _read_tail(buf: bytes, tail_offset: int, count: int,
               elem_sz: int) -> np.ndarray:
    if tail_offset + count * elem_sz > len(buf):
        raise CorruptStreamError(
            f"verbatim tail truncated: need {tail_offset + count * elem_sz} "
            f"bytes, have {len(buf)}")
    return np.frombuffer(buf, dtype=np.uint8 if elem_sz == 1 else np.uint16,
                         count=count, offset=tail_offset)


def _metadata(buf: bytes, sidecar: Sidecar) -> tuple[int, int, int, bool]:
    if len(buf) < METADATA_LEN_RLE:
        raise CorruptStreamError(
            f"stream shorter than its {METADATA_LEN_RLE}-byte metadata "
            f"({len(buf)} bytes)")
    ngroups, remaining, ndims = read_metadata_rle(buf)
    if ndims != sidecar.ndims:
        raise CorruptStreamError(f"sidecar of {sidecar.ndims} dims for a "
                                 f"stream of {ndims}")
    return ngroups, remaining, ndims, ndims <= LOWDIM_MAX_NDIMS[
        sidecar.elem_sz]


def decompress_parallel(buf: bytes, sidecar: Sidecar,
                        device: str | torch.device | None = None
                        ) -> np.ndarray:
    """Chunk-parallel decode of a stream with its sidecar -> the flat
    elements, ``decoder.decompress``'s for the stream's own sidecar.

    The stream splits at the sidecar's checkpoints into chunks that each
    enter at their recorded state: the header walk runs a thread a run of
    segments, and the device pass decodes every chunk at once (FIRE: C·D
    lanes where the serial decode has D). A stream of no groups, and a
    sidecar of one checkpoint, take the serial ``decoder.decompress`` on
    the same device, as in the JAX package. Raises ``CorruptStreamError``
    where the JAX package does: segment rows that do not stitch to the
    recorded row offsets, offsets that do not rise from row 0."""
    dev = resolve_device(device)
    elem_sz = sidecar.elem_sz
    ngroups, remaining, ndims, lowdim = _metadata(buf, sidecar)
    if ngroups == 0:
        return decoder.decompress(buf, sidecar.codec, elem_sz, dev)
    bo = np.asarray(sidecar.byte_offsets, dtype=np.int64)
    ro = np.asarray(sidecar.row_offsets, dtype=np.int64)
    idx = decoder.walk_headers_parallel(
        buf, ngroups, ndims, elem_sz, bo, ro, sidecar.every_groups, lowdim)
    if idx.widths.shape[0] == 0 or bo.size <= 1:
        return decoder.decompress(buf, sidecar.codec, elem_sz, dev)
    if (np.any(np.diff(np.append(ro, idx.total_rows)) < 0) or ro[0] != 0
            or np.any(np.diff(bo) <= 0)):
        raise CorruptStreamError(
            "sidecar inconsistent with stream: checkpoint offsets must be "
            "strictly increasing and start at row 0")
    if np.any(ro % BLOCK_SZ):
        raise CorruptStreamError(
            "sidecar inconsistent with stream: a checkpoint row is not on a "
            "block boundary")
    tail = _read_tail(buf, idx.tail_offset, remaining, elem_sz)
    states = np.zeros((bo.size, 3, ndims), np.int32)
    states[:, : sidecar.states.shape[1]] = sidecar.states
    vals = decoder.decode_device(
        *decoder.upload_payload(decoder.gather_payloads(buf, idx), idx, dev),
        idx.total_rows, elem_sz, sidecar.codec, lowdim,
        chunks=(ro // BLOCK_SZ, states))
    return decoder.join_tail(decoder.download_values(vals), tail)


def decode_range(buf: bytes, sidecar: Sidecar, start_row: int, nrows: int,
                 device: str | torch.device | None = None) -> np.ndarray:
    """Rows [start_row, start_row + nrows) of the stream, (n, D), without
    replaying the stream before them: seek to the last checkpoint at or
    before start_row, decode forward from its state, slice. Rows from the
    verbatim tail follow where the range reaches past the coded blocks."""
    elem_sz = sidecar.elem_sz
    ngroups, remaining, ndims, lowdim = _metadata(buf, sidecar)
    if ngroups == 0 or len(sidecar.row_offsets) == 0:
        flat = decoder.decompress(buf, sidecar.codec, elem_sz, device)
        whole = flat[: flat.size // ndims * ndims].reshape(-1, ndims)
        return whole[start_row: start_row + nrows]
    k = int(np.searchsorted(sidecar.row_offsets, start_row, side="right")) - 1
    k = max(k, 0)
    row_off = int(sidecar.row_offsets[k])
    idx = decoder.walk_headers(
        buf, max(ngroups - k * sidecar.every_groups, 0), ndims, elem_sz,
        lowdim, start=int(sidecar.byte_offsets[k]))
    vals = decoder.decode_indexed(buf, idx, ndims, elem_sz, sidecar.codec,
                                  init_state=sidecar.states[k], device=device)
    lo = start_row - row_off
    if lo + nrows > vals.shape[0] and remaining >= ndims:
        tail = _read_tail(buf, idx.tail_offset, remaining // ndims * ndims,
                          elem_sz)
        vals = np.concatenate([vals, tail.reshape(-1, ndims)])
    return vals[lo: lo + nrows]
