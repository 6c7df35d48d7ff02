"""Encoder (delta and FIRE): device pass + host plan/assembly.

Counterpart of ``sprintz_tpu/encoder.py`` for its two layouts: row-major
(u8 ndims > 4, u16 ndims > 2) and lowdim (the rest: column-major blocks).

1. Device: the forecast of every block (delta: a shifted subtract; FIRE:
   ``fire_encode``'s serial scan over rows, parallel over dims, with the
   lowdim layout's full-precision coefficient there), zigzag, per-block
   per-dim widths and header fields, and the bit-pack of every block:
   row-major into a dense (nb, 8, D * elem_sz) buffer by K3 ``pack_rows``,
   lowdim into a dense (nb, D, 8 * elem_sz) buffer of one section a
   (block, dim) by ``encode_lowdim``, one kernel from the narrow rows
   (delta) or FIRE's errors to every output of the pass. Forecaster state
   does not depend on the RLE/group structure, so this is one pass over
   the blocks.
2. Host: the group/RLE emission plan from the per-block zero flags
   (``planner.build_plan``), O(blocks) bookkeeping.
3. Host: the final byte stream (headers, payload slices of the dense
   buffer, run varints, verbatim tail).

Both host steps run in the port's host library (``native_host``, C++).

Each stage carries its span (``utils.trace.annotate``): ``encode.upload``,
``encode.device``, ``encode.download``, ``encode.plan``
(``planner.build_plan``), ``encode.assemble``; the transfers count their
``pageable_bytes`` and ``pinned_bytes`` on a CUDA device
(``utils.trace.counters``).

Output is byte-identical to the reference and to the JAX package.
``compress_with_layout`` also returns what a checkpoint sidecar is built
from (``checkpoint.compress_with_sidecar``): the blocks the device pass
coded, each group's byte offset and first row (from the assembler, so no
walk over the stream), and on request FIRE's carry before every block
(from the same FIRE launch), with the same bytes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import native_host
from .constants import (
    BLOCK_SZ,
    GROUP_SZ_BLOCKS,
    LOWDIM_MAX_NDIMS,
    MIN_DATA_SIZE,
    nbits_sz_bits,
)
from .device import resolve_device
from .models.forecasters import delta_encode, fire_encode
from .ops.bitmath import block_widths_rowmajor, header_value
from .ops.pack_kernels import (encode_lowdim, pack_rows, rows_dtype,
                               widen_rows)
from .planner import KIND_DATA, KIND_RUN, EmissionPlan, build_plan, pack_headers
from .stream_format import copy_ranges, write_metadata_rle
from .utils import trace
from .utils.trace import annotate


def upload_rows(rows: np.ndarray, device: torch.device,
                narrow: bool = False) -> torch.Tensor:
    """(N, D) u8/u16 rows -> int32 on ``device``, transferred narrow; with
    ``narrow``, as transferred: uint8, or u16 as int16."""
    if not rows.flags.writeable:  # torch.from_numpy wants a writable array
        rows = rows.copy()
    with annotate("encode.upload"):
        if rows.dtype == np.uint16:  # transferred as int16
            t = torch.from_numpy(rows.view(np.int16)).to(device)
            t = t if narrow else t.to(torch.int32) & 0xFFFF
        else:
            t = torch.from_numpy(rows).to(device)
            t = t if narrow else t.to(torch.int32)
    trace.count_transfer(upload_rows, device, rows)
    return t


@annotate("encode.device")
def encode_device(rows: torch.Tensor, elem_sz: int, codec: str = "delta",
                  lowdim: bool = False, fire_states: bool = False):
    """Device pass: rows (N, D), N divisible by 8 ->
    (widths (nb, D), hdr (nb, D), dense u8, width_sums (nb,) int32), all on
    the rows' device. Row-major: rows int32, widths and hdr int32, dense
    (nb, 8, D*elem_sz). ``lowdim``: widths and hdr uint8, dense
    (nb, D, 8*elem_sz); delta takes the rows narrow, as
    ``upload_rows(..., narrow=True)`` gives them (int32 rows are narrowed
    first). With ``fire_states`` (xff), a fifth output: FIRE's (nb, 3, D)
    int32 carry before each block."""
    eb = 8 * elem_sz
    if lowdim and codec == "delta":
        if rows.dtype == torch.int32:
            rows = (rows - ((rows & 0x8000) << 1) if elem_sz == 2
                    else rows).to(rows_dtype(elem_sz))
        return encode_lowdim(rows, elem_sz)
    carries = ()
    if codec == "xff" and fire_states:
        errs, carry = fire_encode(rows, eb, truncate_coeffs=not lowdim,
                                  states=True)
        carries = (carry,)
    elif codec == "xff":
        errs = fire_encode(rows, eb, truncate_coeffs=not lowdim)
    else:
        errs = delta_encode(rows, eb)
    return encode_errors(errs, elem_sz, lowdim) + carries


def encode_errors(errs: torch.Tensor, elem_sz: int, lowdim: bool):
    """The device pass after the forecast: zigzag errors (N, D) int32, N
    divisible by 8 -> (widths, hdr, dense, width_sums) as ``encode_device``
    returns them: row-major through K3 ``pack_rows``, lowdim through
    ``encode_lowdim(errors=True)``."""
    if lowdim:
        return encode_lowdim(errs, elem_sz, errors=True)
    blocks = errs.reshape(-1, BLOCK_SZ, errs.shape[1])
    widths = block_widths_rowmajor(blocks.amax(dim=1), elem_sz)
    return (widths, header_value(widths, 8 * elem_sz),
            pack_rows(blocks, widths, elem_sz),
            widths.sum(dim=1, dtype=torch.int32))


@dataclasses.dataclass
class StreamLayout:
    """What ``compress_with_layout`` knows of the stream it made."""

    nb: int  # blocks the device pass coded (whole rows of 8)
    group_offsets: np.ndarray  # (ngroups,) int64 byte offset of each group
    group_first_rows: np.ndarray  # (ngroups,) int64 its first row
    fire_states: torch.Tensor | None  # (nb, 3, D) int32 on the device


def compress(flat: np.ndarray, ndims: int, codec: str = "delta",
             elem_sz: int | None = None,
             device: str | torch.device | None = None) -> bytes:
    """Compress a flat row-major u8/u16 stream; byte-identical to the
    reference codec.

    ``device``: where the device pass runs, CUDA by default (raises when
    CUDA is absent); ``"cpu"`` runs the kernels' plain versions (tests).
    """
    return compress_with_layout(flat, ndims, codec, elem_sz, device)[0]


def compress_with_layout(flat: np.ndarray, ndims: int, codec: str = "delta",
                         elem_sz: int | None = None,
                         device: str | torch.device | None = None,
                         fire_states: bool = False
                         ) -> tuple[bytes, StreamLayout]:
    """``compress``, also returning the stream's ``StreamLayout``; with
    ``fire_states`` (xff) the FIRE launch also writes its carry before each
    block, which stays on the device."""
    if codec not in ("delta", "xff"):
        raise ValueError(f"codec must be 'delta' or 'xff', got {codec!r}")
    flat = np.ascontiguousarray(flat).reshape(-1)
    elem_sz = flat.dtype.itemsize if elem_sz is None else elem_sz
    if elem_sz not in (1, 2) or flat.dtype != (
            np.uint8 if elem_sz == 1 else np.uint16):
        raise TypeError(f"expected a uint8 or uint16 stream matching "
                        f"elem_sz={elem_sz}, got {flat.dtype}")
    if ndims < 1:
        raise ValueError(f"ndims must be >= 1, got {ndims}")
    dev = resolve_device(device)
    n = flat.size
    none = np.zeros(0, np.int64)
    if n < MIN_DATA_SIZE:
        return (write_metadata_rle(0, n, ndims) + flat.tobytes(),
                StreamLayout(0, none, none, None))
    lowdim = ndims <= LOWDIM_MAX_NDIMS[elem_sz]

    nb = n // (BLOCK_SZ * ndims)
    rows = upload_rows(flat[: nb * BLOCK_SZ * ndims].reshape(-1, ndims), dev,
                       narrow=lowdim and codec == "delta")
    carries = None
    if fire_states and codec == "xff":
        widths, hdr, dense, width_sums, carries = encode_device(
            rows, elem_sz, codec, lowdim, fire_states=True)
    else:
        widths, hdr, dense, width_sums = encode_device(rows, elem_sz, codec,
                                                       lowdim)
    widths_np, hdr_np, dense_np, wsums_np = download_outputs(
        widths, hdr, dense, width_sums)

    # lowdim FIRE takes delta's strict run comparator (encoder.py:346)
    plan = build_plan(wsums_np == 0, n, ndims, codec == "xff" and not lowdim)
    stream, offsets, first_rows = assemble_stream(
        plan, widths_np, hdr_np, dense_np, ndims, elem_sz,
        flat[n - plan.remaining_elems:], lowdim, wsums_np, group_index=True)
    return stream, StreamLayout(nb, offsets, first_rows, carries)


def compress_batch(streams: np.ndarray, codec: str = "delta",
                   device: str | torch.device | None = None) -> list[bytes]:
    """Compress S same-shape streams, (S, nrows, D) u8/u16, in one device
    pass; each stream's bytes are those ``compress`` gives it alone. The
    counterpart of the JAX package's ``encoder.compress_batch``, which
    vmaps its encode pass over the batch.

    The streams go up in one copy, narrow, and are laid out on the device
    as (nb * 8, S * D) lanes: FIRE and delta are column-independent and
    every column starts from the zero state at row 0, so one
    ``fire_encode`` (S * D lanes) or ``delta_encode`` over that layout
    gives each stream its own errors. The errors go back to (S * nb, 8, D)
    blocks for one ``encode_errors`` (K3, or the lowdim encode from
    errors); the lowdim delta takes that route too, since
    ``encode_lowdim``'s delta from the rows would difference each stream's
    first row against the stream before it. One download brings every
    stream's widths, headers, payload and width sums; each stream is then
    planned and assembled on the host with its own tail."""
    if codec not in ("delta", "xff"):
        raise ValueError(f"codec must be 'delta' or 'xff', got {codec!r}")
    streams = np.ascontiguousarray(streams)
    if streams.ndim != 3:
        raise ValueError(f"streams must be (S, nrows, ndims), got shape "
                         f"{streams.shape}")
    if streams.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"expected uint8 or uint16 streams, got "
                        f"{streams.dtype}")
    dev = resolve_device(device)
    nstreams, nrows, ndims = streams.shape
    elem_sz = streams.dtype.itemsize
    n = nrows * ndims
    if n < MIN_DATA_SIZE:
        return [write_metadata_rle(0, n, ndims) + s.tobytes()
                for s in streams]
    nb = nrows // BLOCK_SZ
    if nstreams == 0 or nb == 0:
        return [compress(s.reshape(-1), ndims, codec, elem_sz, dev)
                for s in streams]
    lowdim = ndims <= LOWDIM_MAX_NDIMS[elem_sz]
    nr = nb * BLOCK_SZ
    x = upload_rows(streams[:, :nr].reshape(nstreams * nr, ndims), dev,
                    narrow=True)
    widths, hdr, dense, width_sums = encode_batch_device(
        x.reshape(nstreams, nr, ndims), elem_sz, codec, lowdim)
    widths_np, hdr_np, dense_np, wsums_np = download_outputs(
        widths, hdr, dense, width_sums)

    out = []
    for s in range(nstreams):
        blk = slice(s * nb, (s + 1) * nb)
        plan = build_plan(wsums_np[blk] == 0, n, ndims,
                          codec == "xff" and not lowdim)
        flat = streams[s].reshape(-1)
        out.append(assemble_stream(
            plan, widths_np[blk], hdr_np[blk], dense_np[blk], ndims, elem_sz,
            flat[n - plan.remaining_elems:], lowdim, wsums_np[blk]))
    return out


def download_outputs(widths: torch.Tensor, hdr: torch.Tensor,
                     dense: torch.Tensor, width_sums: torch.Tensor):
    """The device pass's outputs -> numpy on the host: (widths uint8, hdr
    uint8, dense uint8, width sums int32), each in one copy; a copy waits
    for the device pass to finish."""
    with annotate("encode.download"):
        out = (widths.to(torch.uint8).cpu().numpy(),
               hdr.to(torch.uint8).cpu().numpy(), dense.cpu().numpy(),
               width_sums.cpu().numpy())
    trace.count_transfer(download_outputs, dense.device, *out)
    return out


@annotate("encode.device")
def encode_batch_device(x: torch.Tensor, elem_sz: int, codec: str,
                        lowdim: bool):
    """``compress_batch``'s device pass: narrow rows (S, nb * 8, D), as
    ``upload_rows(..., narrow=True)`` gives them -> ``encode_device``'s
    outputs for the S * nb blocks, stream after stream. The forecast runs
    once over the (nb * 8, S * D) lanes."""
    nstreams, nr, ndims = x.shape
    eb = 8 * elem_sz
    lanes = widen_rows(x.permute(1, 0, 2).reshape(
        nr, nstreams * ndims)).contiguous()
    errs = (fire_encode(lanes, eb, truncate_coeffs=not lowdim)
            if codec == "xff" else delta_encode(lanes, eb))
    errs = errs.reshape(nr, nstreams, ndims).permute(1, 0, 2).reshape(
        nstreams * nr, ndims).contiguous()
    return encode_errors(errs, elem_sz, lowdim)


@annotate("encode.assemble")
def assemble_stream(plan: EmissionPlan, widths_np: np.ndarray,
                    hdr_np: np.ndarray, dense_np: np.ndarray, ndims: int,
                    elem_sz: int, tail: np.ndarray, lowdim: bool = False,
                    wsums: np.ndarray | None = None,
                    group_index: bool = False, meta: bytes | None = None):
    """Final stream assembly in the port's host library
    (``native_host.assemble_stream``): group g's header precedes slots 2g
    and 2g+1; a data slot's payload is 8 rows of ceil(sum(widths) / 8)
    bytes (row-major) or its D sections of widths[d] bytes, sum(widths) in
    all (lowdim); a run slot is a 1- or 2-byte varint. ``wsums``: the
    blocks' width sums, which the device pass computes; the library sums
    the widths itself without them. With ``group_index``, returns (stream,
    each group's byte offset, each group's first row). ``meta``: the bytes
    that open the stream in place of the RLE metadata (a non-RLE stream's
    header, or none: ``simple.py``).
    ``_assemble_stream_py`` is its plain version (``checkpoint``'s
    ``_group_index_py`` that of the group index)."""
    return native_host.assemble_stream(
        plan.kinds, plan.values, plan.ngroups, plan.remaining_elems,
        widths_np, hdr_np, dense_np, ndims, elem_sz, lowdim, tail, wsums,
        group_index, meta)


def _assemble_stream_py(plan: EmissionPlan, widths_np: np.ndarray,
                        hdr_np: np.ndarray, dense_np: np.ndarray, ndims: int,
                        elem_sz: int, tail: np.ndarray,
                        lowdim: bool = False,
                        meta: bytes | None = None) -> bytes:
    """``assemble_stream``'s plain version, with numpy index arithmetic."""
    head = (write_metadata_rle(plan.ngroups, plan.remaining_elems, ndims)
            if meta is None else bytes(meta))
    hdr_bits = nbits_sz_bits(elem_sz)
    total_header_bytes = (ndims * hdr_bits * GROUP_SZ_BLOCKS + 7) // 8

    kinds = plan.kinds
    values = plan.values
    nslots = plan.nslots
    data_mask = kinds == KIND_DATA
    run_mask = kinds == KIND_RUN
    data_vals = values[data_mask]

    # per-slot payload lengths
    slot_len = np.ones(nslots, dtype=np.int64)  # run0 -> 1 byte
    wsum = widths_np.sum(axis=1, dtype=np.int64)
    row_nbytes = (wsum + 7) // 8
    slot_len[data_mask] = (wsum if lowdim else BLOCK_SZ * row_nbytes)[data_vals]
    slot_len[run_mask] = 1 + (values[run_mask] > 0x7F)

    # output offsets: META + headers before/within + payloads before
    cum_payload = np.concatenate([[0], np.cumsum(slot_len)])
    slot_off = (len(head)
                + total_header_bytes * (np.arange(nslots) // GROUP_SZ_BLOCKS + 1)
                + cum_payload[:-1])
    total = int(slot_off[-1] + slot_len[-1]) if nslots else len(head)
    out = np.zeros(total + tail.nbytes, dtype=np.uint8)
    out[:len(head)] = np.frombuffer(head, dtype=np.uint8)

    # headers
    slot_headers = np.zeros((nslots, ndims), dtype=np.uint8)
    slot_headers[data_mask] = hdr_np[data_vals]
    header_bytes = pack_headers(slot_headers, hdr_bits)
    hdr_off = slot_off[::GROUP_SZ_BLOCKS] - total_header_bytes
    out[hdr_off[:, None] + np.arange(total_header_bytes)[None, :]] = header_bytes

    # run varints
    run_off = slot_off[run_mask]
    run_val = values[run_mask].astype(np.int64)
    two = run_val > 0x7F
    out[run_off] = (run_val & 0x7F) | (two.astype(np.int64) << 7)
    out[run_off[two] + 1] = run_val[two] >> 7

    # data payloads: lowdim units are (block, dim) sections of w bytes at
    # the block's offset plus the exclusive cumsum of its widths; row-major
    # units are rows, 8 per block, rb bytes each
    if data_vals.size and lowdim:
        w = widths_np[data_vals].astype(np.int64)  # (ndata, D)
        unit_len = w.reshape(-1)
        unit_out = (np.repeat(slot_off[data_mask], ndims)
                    + (np.cumsum(w, axis=1) - w).reshape(-1))
        unit_src = ((data_vals[:, None].astype(np.int64) * ndims
                     + np.arange(ndims)[None, :]).reshape(-1)
                    * dense_np.shape[2])
        copy_ranges(out, unit_out, dense_np.reshape(-1), unit_src, unit_len)
    elif data_vals.size:
        doff = slot_off[data_mask]
        rb = row_nbytes[data_vals]
        unit_len = np.repeat(rb, BLOCK_SZ)
        unit_out = (np.repeat(doff, BLOCK_SZ)
                    + np.tile(np.arange(BLOCK_SZ), rb.size) * unit_len)
        unit_src = ((data_vals[:, None].astype(np.int64) * BLOCK_SZ
                     + np.arange(BLOCK_SZ)[None, :]).reshape(-1)
                    * dense_np.shape[2])
        copy_ranges(out, unit_out, dense_np.reshape(-1), unit_src, unit_len)

    if tail.nbytes:
        out[total:] = np.frombuffer(tail.tobytes(), dtype=np.uint8)
    return out.tobytes()


for _fn in (upload_rows, download_outputs):
    trace.count(_fn, pageable_bytes=0, pinned_bytes=0)
