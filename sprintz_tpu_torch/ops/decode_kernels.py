"""Delta decode kernels: payload bytes -> reconstructed values.

Counterpart of ``sprintz_tpu/ops/pallas_decode.py``. Two CUDA kernels
(``csrc/decode.cu``), nothing between them:

- K1 ``unpack_zz``: field extraction fused with the zigzag decode,
  emitting narrow u8/u16 deltas biased to unsigned, plus each tile's
  per-dim exclusive offset: the exclusive scan of the tile totals that the
  JAX package runs in XLA between its kernels (``pallas_decode.py:207``),
  which the kernel computes by a look-back across its CTAs.
- K2 ``prefix_finish``: each tile's inclusive prefix plus its offset,
  masked and narrowed.

The lowdim layout (u8 ndims <= 4, u16 ndims <= 2) has one kernel for the
whole delta decode, ``decode_delta_lowdim`` (``decode_lowdim_kernel``:
sections to values, the unpack, zigzag and prefix of K1 and K2 in one
pass); its raw mode ``unpack_dims_lowdim`` feeds the FIRE decode.
A decode from a checkpoint sidecar, or of a batch's streams, is cut into
chunks that each start from a state of their own (``Chunks``, made by
``chunk_args``): K1, K2 and the lowdim decode take them (``chunks=``) and
fold each chunk's state into their look-back and prefix, in the same
launches; ``delta_chunk_seed_plain`` is what a chunked decode adds to the
serial one.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
PyTorch version (``*_plain``, computed in int32, narrowed at the end) for a
CPU tensor; the plain versions are what the CPU tests run and what the
kernels are held against on the card. A wrapper's ``launches`` attribute
counts its kernel launches, and ``chunk_launches`` its chunked ones.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import BLOCK_SZ
from . import _build

# Blocks per tile: the JAX pipeline's default (decode_delta_contiguous's
# block_tile), so tile totals match it. K1 sums each tile of TILE_BLOCKS
# blocks and K2 scans each tile of TILE_ROWS rows: one tile size for both,
# csrc/decode.cu's TILE_BLOCKS and TILE_ROWS.
TILE_BLOCKS = 32
TILE_ROWS = TILE_BLOCKS * BLOCK_SZ


def narrow_dtype(elem_bits: int) -> torch.dtype:
    if elem_bits not in (8, 16):
        raise ValueError(f"elem_bits must be 8 or 16, got {elem_bits}")
    return torch.uint8 if elem_bits == 8 else torch.uint16


def narrow(x: torch.Tensor, elem_bits: int) -> torch.Tensor:
    """int32 values in [0, 2^eb) -> u8/u16. uint16 is only a storage type
    in torch, so u16 values are written through int16 and reinterpreted."""
    if narrow_dtype(elem_bits) == torch.uint8:
        return x.to(torch.uint8)
    return (x - ((x & 0x8000) << 1)).to(torch.int16).view(torch.uint16)


def widen(t: torch.Tensor) -> torch.Tensor:
    """u8/u16 -> int32 (the inverse of ``narrow``)."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int32) & 0xFFFF
    return t.to(torch.int32)


def check_args(name: str, device: torch.device, **tensors) -> None:
    """Raise unless every tensor is a contiguous tensor of the dtype the
    kernel takes, on ``device`` (CUDA or CPU). ``tensors`` maps an
    argument name to (tensor, dtype)."""
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {device}")
    for arg, (t, dtype) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def check_payload(name: str, dense: torch.Tensor,
                  widths: torch.Tensor) -> None:
    """Checks of an unpack kernel's inputs: dense (nb, 8, MAXB) uint8 and
    widths (nb, D) uint8 (the header walk's) on one device."""
    check_args(name, dense.device, dense=(dense, torch.uint8),
               widths=(widths, torch.uint8))
    if (dense.dim() != 3 or widths.dim() != 2 or dense.shape[1] != BLOCK_SZ
            or widths.shape[0] != dense.shape[0] or dense.shape[2] < 1):
        raise ValueError(f"{name}: dense {tuple(dense.shape)} and widths "
                         f"{tuple(widths.shape)} are not (nb, 8, MAXB) and "
                         f"(nb, D)")


def extract_fields(dense: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """Plain field extraction: dense (nb, 8, MAXB) u8, widths (nb, D) ->
    zigzag fields (nb, 8, D) int32. Bytes at or past MAXB read as 0."""
    maxb = dense.shape[2]
    w = widths.to(torch.int32)
    off = torch.cumsum(w, dim=1, dtype=torch.int32) - w
    q = (off >> 3).unsqueeze(1).expand(-1, BLOCK_SZ, -1)  # (nb, 8, D)
    d32 = dense.to(torch.int32)
    word = torch.zeros(q.shape, dtype=torch.int32, device=dense.device)
    for k in range(3):  # u16 fields shifted by <= 7 bits span 3 bytes
        idx = q + k
        byte = torch.gather(d32, 2, idx.clamp(max=maxb - 1).long())
        word |= torch.where(idx < maxb, byte, 0) << (8 * k)
    return (word >> (off & 7).unsqueeze(1)) & ((1 << w) - 1).unsqueeze(1)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array -> a tensor on the CUDA ``device``, through a
    pinned staging buffer (PyTorch caches them), so the copy is queued on
    the stream and the host does not wait for the work before it, as a
    copy from pageable memory does."""
    return to_device_together([a], device)[0]


def to_device_together(arrays: list[np.ndarray],
                       device: torch.device) -> list[torch.Tensor]:
    """Small host arrays -> tensors on the CUDA ``device`` in one copy, as
    ``to_device``: back to back in one pinned buffer, each from 16 bytes."""
    offs, n = [], 0
    for a in arrays:
        offs.append(n)
        n += -(-a.nbytes // 16) * 16
    staged = torch.empty(max(n, 16), dtype=torch.uint8, pin_memory=True)
    host = staged.numpy()
    for a, o in zip(arrays, offs):
        host[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    dev = staged.to(device, non_blocking=True)
    return [dev[o:o + a.nbytes].view(torch.from_numpy(a[:0]).dtype).reshape(a.shape)
            for a, o in zip(arrays, offs)]


class Chunks(NamedTuple):
    """A decode cut into C chunks of whole blocks, chunk c blocks
    ``first[c]`` to ``first[c + 1]`` from its own state: ``first`` (C + 1,)
    int64 from 0 to the decode's blocks, on the host and (``first_d``) on
    the decode's device, and ``states`` there, (C, ...) int32."""

    first: np.ndarray
    first_d: torch.Tensor
    states: torch.Tensor


def chunk_args(name: str, first, states, nb: int, state_shape: tuple,
               device: torch.device) -> Chunks:
    """A chunked decode's chunks, checked (``first`` rises from 0 to ``nb``;
    ``states`` is (C,) + ``state_shape``, numpy or torch) and on ``device``:
    on CUDA the chunk starts and numpy states go up in one pinned copy."""
    f = np.asarray(first, dtype=np.int64).reshape(-1)
    if f.size < 2 or f[0] != 0 or f[-1] != nb or np.any(np.diff(f) < 0):
        raise ValueError(f"{name}: chunk_first_block must rise from 0 to {nb} "
                         f"(C + 1 block indices), got {f[:4].tolist()}..."
                         f"{f[-2:].tolist()}")
    want = (f.size - 1,) + tuple(state_shape)
    if tuple(np.shape(states)) != want:
        raise ValueError(f"{name}: states {tuple(np.shape(states))} is not "
                         f"{want}")
    if torch.is_tensor(states):
        st = states.to(device, torch.int32).contiguous()
        fd = to_device(f, device) if device.type == "cuda" else torch.from_numpy(f)
    elif device.type == "cuda":
        fd, st = to_device_together(
            [f, np.ascontiguousarray(states, dtype=np.int32)], device)
    else:
        fd, st = torch.from_numpy(f), torch.from_numpy(
            np.array(states, dtype=np.int32))
    return Chunks(f, fd, st)


def delta_chunks(first, states, nb: int, ndims: int,
                 device: torch.device) -> Chunks:
    """``chunk_args`` of a delta decode: states (C, D), each chunk's value
    before its first row."""
    return chunk_args("delta decode", first, states, nb, (ndims,), device)


def _chunk_launch_args(chunks: Chunks | None, nb: int, ndims: int,
                       device: torch.device, name: str):
    """(first, nchunks, states) pointers of a launch; raises where the
    chunks are not of this decode."""
    if chunks is None:
        return None, 0, None
    if (chunks.first[-1] != nb or tuple(chunks.states.shape)
            != (chunks.first.size - 1, ndims)
            or chunks.states.device != device or chunks.first_d.device != device):
        raise ValueError(f"{name}: chunks of {chunks.first[-1]} blocks and "
                         f"states {tuple(chunks.states.shape)} are not those "
                         f"of {nb} blocks of {ndims} dims on {device}")
    return (chunks.first_d.data_ptr(), chunks.first.size - 1,
            chunks.states.data_ptr())


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on 16 bytes:
    the kernels stage and store 16 bytes at a time."""
    return t.clone() if t.data_ptr() % 16 else t


def tiled(deltas: torch.Tensor) -> torch.Tensor:
    """(rows, D) -> (ntiles, TILE_ROWS, D), the short last tile padded
    with zero deltas."""
    rows, ndims = deltas.shape
    pad = (-rows) % TILE_ROWS
    if pad:
        deltas = torch.cat([deltas, deltas.new_zeros((pad, ndims))])
    return deltas.reshape(-1, TILE_ROWS, ndims)


# ------------------------------------------------------------------ K1


def unpack_zz_plain(dense: torch.Tensor, widths: torch.Tensor,
                    elem_bits: int, chunks: Chunks | None = None):
    """Plain version of ``unpack_zz``."""
    return zz_and_offsets(extract_fields(dense, widths), elem_bits, chunks)


def zz_and_offsets(u: torch.Tensor, elem_bits: int,
                   chunks: Chunks | None = None):
    """Zigzag fields (nb, 8, D) int32 -> (biased narrow deltas, the tiles'
    exclusive offsets): K1's output from its fields (with ``chunks``, the
    value entering each tile, ``chunk_bases``)."""
    delta = (u >> 1) ^ -(u & 1)
    nb, _, ndims = u.shape
    bz = narrow(delta + (1 << (elem_bits - 1)), elem_bits)
    if chunks is not None:
        rows = torch.arange(0, nb * BLOCK_SZ, TILE_ROWS, device=u.device)
        return bz, chunk_bases(delta.reshape(-1, ndims), chunks, rows)[:, None]
    tots = tiled(delta.reshape(nb * BLOCK_SZ, ndims)).sum(
        dim=1, keepdim=True, dtype=torch.int32)
    return bz, exclusive_offsets(tots)


def extract_totals(bz: torch.Tensor, elem_bits: int) -> torch.Tensor:
    """Biased narrow deltas (nb, 8, D) -> the (D,) int64 sum of the
    deltas."""
    rows = widen(bz.reshape(-1, bz.shape[-1])).to(torch.int64)
    return (rows - (1 << (elem_bits - 1))).sum(dim=0)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32, wrapping as the kernels' 32-bit sums do."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def chunk_bases(deltas: torch.Tensor, chunks: Chunks,
                rows: torch.Tensor) -> torch.Tensor:
    """The value before each row of ``rows`` in a chunked delta decode of
    ``deltas`` (nb * 8, D) int32: its chunk's state plus the chunk's deltas
    above the row, in wrapping int32 -> (len(rows), D)."""
    starts = torch.from_numpy(chunks.first[:-1]).to(deltas.device)
    owner = torch.searchsorted(starts, rows // BLOCK_SZ, right=True) - 1
    above = torch.cat([deltas.new_zeros((1, deltas.shape[1]), dtype=torch.int64),
                       torch.cumsum(deltas, dim=0, dtype=torch.int64)])
    st = chunks.states.to(deltas.device, torch.int64)
    return _wrap32(st[owner] + above[rows] - above[starts[owner] * BLOCK_SZ])


def unpack_zz(dense: torch.Tensor, widths: torch.Tensor, elem_bits: int,
              chunks: Chunks | None = None, total: bool = False):
    """dense (nb, 8, MAXB) uint8, widths (nb, D) uint8 ->
    (biased deltas (nb, 8, D) u8/u16, tile offsets
    (ceil(nb / TILE_BLOCKS), 1, D) i32: the wrapping sum of the deltas of
    every tile before each).

    MAXB is ``dense.shape[2]``, which may be less than D * elem_sz: bytes
    at or past it read as zero. With ``chunks`` (``delta_chunks``: states
    (C, D)) a tile's offset is the value entering it in the chunked decode
    (``chunk_bases``): its chunk's state plus the chunk's deltas before it.
    With ``total`` (serial only), a third output: the (D,) i32 wrapping sum
    of all the deltas, which the launch leaves in its last tile's status
    words (the inclusive prefix its look-back publishes), so no pass reads
    the deltas for it: a shard's total for the sharded decode's prefix.
    """
    odt = narrow_dtype(elem_bits)
    check_payload("unpack_zz", dense, widths)
    nb, _, maxb = dense.shape
    ndims = widths.shape[1]
    if total and chunks is not None:
        raise ValueError("unpack_zz: total is the serial decode's")
    ck = _chunk_launch_args(chunks, nb, ndims, dense.device, "unpack_zz")
    if dense.device.type == "cpu":
        bz, toff = unpack_zz_plain(dense, widths, elem_bits, chunks)
        if not total:
            return bz, toff
        return bz, toff, _wrap32(extract_totals(bz, elem_bits))
    ntiles = -(-nb // TILE_BLOCKS)
    bz = torch.empty((nb, BLOCK_SZ, ndims), dtype=odt, device=dense.device)
    toff = torch.empty((ntiles, 1, ndims), dtype=torch.int32,
                       device=dense.device)
    if nb == 0 or ndims == 0:
        toff.zero_()
        return (bz, toff, toff.new_zeros(ndims)) if total else (bz, toff)
    dense, widths = aligned16(dense), aligned16(widths)
    # the look-back's status words and its ticket, zeroed by the launch
    status = torch.empty(ntiles * ndims + 1, dtype=torch.int64,
                         device=dense.device)
    _build.launch("sprintz_unpack_zz", dense, dense.data_ptr(),
                  widths.data_ptr(), bz.data_ptr(), toff.data_ptr(),
                  status.data_ptr(), nb, ndims, maxb, elem_bits, 0, *ck)
    if chunks is None:
        unpack_zz.launches += 1
    else:
        unpack_zz.chunk_launches += 1
    if total:
        # a status word is flag << 32 | value: the value is its low int32
        last = status[(ntiles - 1) * ndims:ntiles * ndims]
        return bz, toff, last.view(torch.int32)[0::2]
    return bz, toff


unpack_zz.launches = 0
unpack_zz.chunk_launches = 0


# ------------------------------------------------------------------ K2


def prefix_finish_plain(bz: torch.Tensor, tile_offsets: torch.Tensor,
                        elem_bits: int,
                        chunks: Chunks | None = None) -> torch.Tensor:
    """Plain version of ``prefix_finish``."""
    rows, ndims = bz.shape
    deltas = widen(bz) - (1 << (elem_bits - 1))
    mask = (1 << elem_bits) - 1
    if chunks is None:
        inner = torch.cumsum(tiled(deltas), dim=1, dtype=torch.int32)
        vals = (inner + tile_offsets) & mask
        return narrow(vals.reshape(-1, ndims)[:rows], elem_bits)
    # segments start at each tile (from its offset) and at each chunk start
    # (from the chunk's state, which wins where both start)
    f = chunks.first
    live = np.flatnonzero(f[:-1] < f[1:])  # a start's chunk: the non-empty one
    base = torch.zeros((rows, ndims), dtype=torch.int64, device=bz.device)
    start = torch.zeros(rows, dtype=torch.bool, device=bz.device)
    base[::TILE_ROWS] = tile_offsets[:, 0].to(torch.int64)
    start[::TILE_ROWS] = True
    at = torch.from_numpy(f[live] * BLOCK_SZ).to(bz.device)
    base[at] = chunks.states[torch.from_numpy(live).to(bz.device)].to(
        bz.device, torch.int64)
    start[at] = True
    seg = torch.cumsum(start, dim=0) - 1
    seg_row = torch.nonzero(start)[:, 0]
    above = torch.cat([deltas.new_zeros((1, ndims), dtype=torch.int64),
                       torch.cumsum(deltas, dim=0, dtype=torch.int64)])
    vals = (base[seg_row][seg] + above[1:] - above[seg_row][seg]) & mask
    return narrow(vals.to(torch.int32), elem_bits)


def prefix_finish(bz: torch.Tensor, tile_offsets: torch.Tensor,
                  elem_bits: int,
                  chunks: Chunks | None = None) -> torch.Tensor:
    """bz (rows, D) biased narrow deltas; tile_offsets (ntiles, 1, D) i32,
    the exclusive prefix entering each TILE_ROWS-row tile -> values
    (rows, D) narrow. The last tile may be short. With ``chunks``
    (``delta_chunks``, rows = 8 x their blocks) the rows from a chunk start
    on take the chunk's state in place of the tile's offset."""
    odt = narrow_dtype(elem_bits)
    check_args("prefix_finish", bz.device, bz=(bz, odt),
               tile_offsets=(tile_offsets, torch.int32))
    rows, ndims = bz.shape
    ntiles = -(-rows // TILE_ROWS)
    if tuple(tile_offsets.shape) != (ntiles, 1, ndims):
        raise ValueError(f"prefix_finish: tile_offsets {tuple(tile_offsets.shape)}"
                         f" != {(ntiles, 1, ndims)}")
    if chunks is not None and rows % BLOCK_SZ:
        raise ValueError(f"prefix_finish: {rows} rows are not whole blocks")
    ck = _chunk_launch_args(chunks, rows // BLOCK_SZ, ndims, bz.device,
                            "prefix_finish")
    if bz.device.type == "cpu":
        return prefix_finish_plain(bz, tile_offsets, elem_bits, chunks)
    out = torch.empty_like(bz)
    if rows == 0 or ndims == 0:
        return out
    bz, tile_offsets = aligned16(bz), aligned16(tile_offsets)
    _build.launch("sprintz_prefix_finish", bz, bz.data_ptr(),
                  tile_offsets.data_ptr(), out.data_ptr(), rows, ndims,
                  elem_bits, *ck)
    if chunks is None:
        prefix_finish.launches += 1
    else:
        prefix_finish.chunk_launches += 1
    return out


prefix_finish.launches = 0
prefix_finish.chunk_launches = 0


# ------------------------------------------------------- lowdim decode

LOWDIM_THREADS = 256  # csrc/decode.cu's LD_THREADS
LOWDIM_SECTION_BYTES = 32  # ndims * elem_bits at most: D <= 4 u8, D <= 2 u16


def lowdim_span_blocks(elem_bits: int, ndims: int) -> int:
    """Blocks a CTA of the lowdim kernels owns (``LowdimShape::SPAN`` in
    csrc/decode.cu and csrc/pack.cu): LOWDIM_THREADS threads of K whole
    blocks, K = 4 / (ndims * elem_bits / 8), 1 at u8 D 3."""
    rb = ndims * elem_bits // 8
    return LOWDIM_THREADS * (1 if rb == 3 else 4 // rb)


def check_lowdim_payload(name: str, dense: torch.Tensor,
                         widths: torch.Tensor) -> int:
    """Checks of a lowdim decode's inputs: dense (nb, D, EB) uint8 with EB
    8 or 16 (elem_bits) and D * EB <= 32, widths (nb, D) uint8, on one
    device. Returns EB."""
    check_args(name, dense.device, dense=(dense, torch.uint8),
               widths=(widths, torch.uint8))
    if (dense.dim() != 3 or tuple(widths.shape) != tuple(dense.shape[:2])
            or dense.shape[2] not in (8, 16) or dense.shape[1] < 1
            or dense.shape[1] * dense.shape[2] > LOWDIM_SECTION_BYTES):
        raise ValueError(f"{name}: dense {tuple(dense.shape)} and widths "
                         f"{tuple(widths.shape)} are not a lowdim payload "
                         f"(nb, D, EB) and (nb, D), EB 8 or 16, D * EB <= "
                         f"{LOWDIM_SECTION_BYTES}")
    return dense.shape[2]


def extract_fields_lowdim(dense: torch.Tensor,
                          widths: torch.Tensor) -> torch.Tensor:
    """Plain lowdim field extraction: dense (nb, D, EB) u8, widths (nb, D)
    -> zigzag fields (nb, 8, D) int32. Field r of a (block, dim) lies at
    bit r * w of its section, read from the 3 bytes at (r * w) >> 3
    (bytes past EB read as 0)."""
    eb = dense.shape[2]
    w = widths.to(torch.int32).unsqueeze(2)  # (nb, D, 1)
    off = torch.arange(BLOCK_SZ, dtype=torch.int32, device=dense.device) * w
    q = off >> 3  # (nb, D, 8)
    d32 = dense.to(torch.int32)
    word = torch.zeros(q.shape, dtype=torch.int32, device=dense.device)
    for k in range(3):
        idx = q + k
        byte = torch.gather(d32, 2, idx.clamp(max=eb - 1).long())
        word |= torch.where(idx < eb, byte, 0) << (8 * k)
    fields = (word >> (off & 7)) & ((1 << w) - 1)
    return fields.transpose(1, 2).contiguous()


def decode_delta_lowdim_plain(dense: torch.Tensor, widths: torch.Tensor,
                              elem_bits: int,
                              chunks: Chunks | None = None) -> torch.Tensor:
    """Plain version of ``decode_delta_lowdim``: K1's contract on the
    lowdim fields (biased deltas, tile offsets), then K2's plain version."""
    nb, ndims, _ = dense.shape
    bz, toff = zz_and_offsets(extract_fields_lowdim(dense, widths), elem_bits,
                              chunks)
    return prefix_finish_plain(bz.reshape(nb * BLOCK_SZ, ndims), toff,
                               elem_bits, chunks)


# The lowdim decode's status words, one zeroed buffer a (device, stream):
# each launch leaves them zeroed (its last CTA clears them), so only a new
# or grown buffer costs a memset.
_lowdim_status: dict[tuple[int, int], torch.Tensor] = {}


def lowdim_status(device: torch.device, nwords: int) -> torch.Tensor:
    """At least ``nwords`` zeroed status words for a lowdim decode on
    ``device``'s current stream."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _lowdim_status.get(key)
    if buf is None or buf.numel() < nwords:
        buf = _lowdim_status[key] = torch.zeros(nwords, dtype=torch.int64,
                                                device=device)
    return buf


def decode_delta_lowdim(dense: torch.Tensor, widths: torch.Tensor,
                        elem_bits: int,
                        chunks: Chunks | None = None) -> torch.Tensor:
    """Run-free lowdim delta decode: dense (nb, D, EB = elem_bits) uint8
    sections, widths (nb, D) uint8 -> values (nb*8, D) u8/u16, the running
    sum of the zigzag-decoded fields down each dim modulo 2^elem_bits, in
    one kernel; with ``chunks`` (``delta_chunks``) each chunk's from its
    state."""
    odt = narrow_dtype(elem_bits)
    if check_lowdim_payload("decode_delta_lowdim", dense, widths) != elem_bits:
        raise ValueError(f"decode_delta_lowdim: sections of {dense.shape[2]} "
                         f"bytes are not those of elem_bits {elem_bits}")
    nb, ndims, _ = dense.shape
    ck = _chunk_launch_args(chunks, nb, ndims, dense.device,
                            "decode_delta_lowdim")
    if dense.device.type == "cpu":
        return decode_delta_lowdim_plain(dense, widths, elem_bits, chunks)
    out = torch.empty((nb * BLOCK_SZ, ndims), dtype=odt, device=dense.device)
    if nb == 0:
        return out
    dense, widths = aligned16(dense), aligned16(widths)
    nspans = -(-nb // lowdim_span_blocks(elem_bits, ndims))
    status = lowdim_status(dense.device, nspans + 1)
    _build.launch("sprintz_decode_lowdim", dense, dense.data_ptr(),
                  widths.data_ptr(), out.data_ptr(), status.data_ptr(), nb,
                  ndims, elem_bits, 0, *ck)
    if chunks is None:
        decode_delta_lowdim.launches += 1
    else:
        decode_delta_lowdim.chunk_launches += 1
    return out


decode_delta_lowdim.launches = 0
decode_delta_lowdim.chunk_launches = 0


def unpack_dims_lowdim_plain(dense: torch.Tensor,
                             widths: torch.Tensor) -> torch.Tensor:
    """Plain version of ``unpack_dims_lowdim``."""
    fields = extract_fields_lowdim(dense, widths)
    return fields.to(torch.uint8) if dense.shape[2] == 8 else fields


def unpack_dims_lowdim(dense: torch.Tensor,
                       widths: torch.Tensor) -> torch.Tensor:
    """Raw mode of the lowdim decode: dense (nb, D, EB) uint8, widths
    (nb, D) uint8 -> zigzag fields (nb, 8, D) in the FIRE decode's types:
    uint8 at EB 8 (fields of u8 streams are at most 8 bits wide) and int32
    at EB 16. The section size tells the element size, so there is no
    ``narrow`` switch as in ``unpack_rows``."""
    eb = check_lowdim_payload("unpack_dims_lowdim", dense, widths)
    if dense.device.type == "cpu":
        return unpack_dims_lowdim_plain(dense, widths)
    nb, ndims, _ = dense.shape
    out = torch.empty((nb, BLOCK_SZ, ndims),
                      dtype=torch.uint8 if eb == 8 else torch.int32,
                      device=dense.device)
    if nb == 0:
        return out
    dense, widths = aligned16(dense), aligned16(widths)
    _build.launch("sprintz_decode_lowdim", dense, dense.data_ptr(),
                  widths.data_ptr(), out.data_ptr(), None, nb, ndims, eb, 1,
                  None, 0, None)
    unpack_dims_lowdim.launches += 1
    return out


unpack_dims_lowdim.launches = 0


# ------------------------------------------------------------ pipeline


def exclusive_offsets(tots: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix of (ntiles, 1, D) tile totals, in wrapping int32
    (K1's plain version; the kernel computes it by its look-back)."""
    return torch.cumsum(tots, dim=0, dtype=torch.int32) - tots


def decode_delta_contiguous(dense: torch.Tensor, widths: torch.Tensor,
                            elem_bits: int,
                            chunks: Chunks | None = None) -> torch.Tensor:
    """Run-free delta decode: payload -> values (nb*8, D) u8/u16.

    dense (nb, 8, MAXB) uint8; widths (nb, D) uint8; ``chunks``
    (``delta_chunks``): each chunk from its state, in the same two
    launches.
    """
    nb = dense.shape[0]
    ndims = widths.shape[1]
    bz, toff = unpack_zz(dense, widths, elem_bits, chunks)
    return prefix_finish(bz.reshape(nb * BLOCK_SZ, ndims), toff, elem_bits,
                         chunks)


# ------------------------------------------------------- the chunk seed


def delta_chunk_seed_plain(vals: torch.Tensor, chunk_first_row, states,
                           elem_bits: int) -> torch.Tensor:
    """Values (rows, D) u8/u16 of a whole delta timeline, the prefix from
    its start -> the values of a decode cut into C chunks, chunk c from its
    own state: rows ``chunk_first_row[c]`` to ``chunk_first_row[c + 1]``
    (C + 1 rows from 0 to ``rows``) become ``states[c]`` + their prefix
    within the chunk, mod 2^elem_bits, as the JAX package's chunk-parallel
    delta decode gives them (a new tensor). ``states`` (C, D) int32, numpy
    or torch. The serial plain decode followed by this is the plain
    version of a chunked decode."""
    rows, ndims = vals.shape
    f = np.asarray(chunk_first_row, dtype=np.int64).reshape(-1)
    if f.size < 2 or f[0] != 0 or f[-1] != rows or np.any(np.diff(f) < 0):
        raise ValueError(f"delta_chunk_seed_plain: chunk_first_row must rise "
                         f"from 0 to {rows} (C + 1 rows)")
    st = torch.as_tensor(states).to(vals.device, torch.int32)
    if tuple(st.shape) != (f.size - 1, ndims):
        raise ValueError(f"delta_chunk_seed_plain: states {tuple(st.shape)} "
                         f"is not {(f.size - 1, ndims)}")
    v = widen(vals)
    mask = (1 << elem_bits) - 1
    starts = torch.from_numpy(f[:-1]).to(vals.device)
    above = torch.where((starts > 0)[:, None], v[(starts - 1).clamp(min=0)], 0)
    corr = (st - above) & mask
    lens = torch.from_numpy(np.diff(f)).to(vals.device)
    return narrow((v + torch.repeat_interleave(corr, lens, dim=0)) & mask,
                  elem_bits)
