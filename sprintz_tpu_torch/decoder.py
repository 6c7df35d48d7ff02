"""Decoder (delta and FIRE): host header walk + device reconstruct.

Counterpart of ``sprintz_tpu/decoder.py`` for its two layouts, row-major
and lowdim (u8 ndims <= 4, u16 ndims <= 2: column-major blocks).
The compressed layout only reveals payload sizes through the group
headers, so offset recovery is a sequential walk over the headers on the
host (``walk_headers``); the payloads are then gathered into one dense
buffer (``gather_payloads``): (ndata, 8, MAXB) rows, or (ndata, D, EB)
sections in the lowdim layout. Both run in the port's host library
(``native_host``, C++), for either device; everything heavy then runs on
the device.
Delta: K1 ``unpack_zz`` (which also scans its tiles' totals into their
offsets) -> K2 ``prefix_finish``; in the lowdim layout one kernel,
``decode_delta_lowdim``, from sections to values. FIRE: K4 ``unpack_rows``
(its narrow mode, K5, at u8),
or the lowdim ``unpack_dims_lowdim``, -> ``fire_decode``'s serial scan
(with the full-precision coefficient in the lowdim layout). A stream with
zero runs first has its payload blocks placed
on the block timeline, with run blocks of width 0 (the byte-gather
timeline of the JAX package's ``decoder.py:582-612``), and then takes the
same kernels: a run block decodes as zero errors, which FIRE runs through
as the encoder did.

The values come back narrow and the verbatim tail is written after them
on the host.

``decompress`` runs as a pipeline of segments of whole groups
(``segment_plan``): an xff stream of at least twice ``PIPE_BYTES`` and
``PIPE_GROUPS`` groups takes several, every other stream one. Each segment is
walked from where the one before stopped, gathered into a pinned upload
slot and uploaded on a copy stream, decoded on the card from the FIRE
carry that the segment before left there, and downloaded into a pinned
slot on a second copy stream; the host walks and gathers the next segment
while the card decodes this one, and waits only to reuse a slot and to
copy a segment's values into the array it returns (``_Pipe``, one a
device and thread; the counter ``segments``). That array lies over a
block of host memory that the module recycles (``_room``, ``_OutPool``):
a block whose last array has died serves a later call with its pages
mapped; the join copies a large result into it on the host library's
threads.

Each stage carries its span (``utils.trace.annotate``): ``decode.walk``,
``decode.gather``, ``decode.upload``, ``decode.device``,
``decode.download``, ``decode.join``; and counters: the walks'
``data_blocks`` and ``run_blocks``, the gather's and the join's
``bytes``, ``_room``'s ``fresh_bytes`` and ``recycled_bytes`` (the output
blocks allocated anew and served from the pool), and each transfer's
``pageable_bytes`` and ``pinned_bytes`` on a CUDA device
(``utils.trace.counters``).

A checkpoint sidecar (``checkpoint.py``) splits the same pass into chunks:
``walk_headers_parallel`` walks the sidecar's segments on threads, and
``decode_device(chunks=...)`` decodes the whole timeline at once with each
chunk from its recorded state (``fire_decode_chunks``; delta's kernels with
``chunks=``, in the serial decode's launches), so the values come out in
order.
``decode_indexed`` is the serial decode of a walk that starts mid-stream,
from a checkpoint's state (``checkpoint.decode_range``).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading

import numpy as np
import torch

from .constants import (
    BLOCK_SZ,
    GROUP_SZ_BLOCKS,
    LOWDIM_MAX_NDIMS,
    METADATA_LEN_RLE,
    MIN_DATA_SIZE,
    nbits_sz_bits,
)
from . import native_host
from .device import resolve_device
from .errors import CorruptStreamError
from .models.forecasters import fire_decode, fire_decode_chunks
from .ops.bitmath import header_to_width
from .ops.decode_kernels import (
    decode_delta_contiguous,
    decode_delta_lowdim,
    delta_chunks,
    unpack_dims_lowdim,
)
from .ops.pack_kernels import unpack_rows
from .planner import unpack_headers
from .stream_format import copy_ranges, read_metadata_rle
from .utils import trace
from .utils.trace import annotate


@dataclasses.dataclass
class StreamIndex:
    """Result of the host header walk: where everything lives."""

    widths: np.ndarray  # (ndata, D) uint8 per data block (max width 16)
    payload_offsets: np.ndarray  # (ndata,) int64 byte offset of block payload
    out_rows: np.ndarray  # (ndata,) int64 starting row of each data block
    row_bytes: np.ndarray  # (ndata,) int32 ceil(sum(widths) / 8)
    total_rows: int
    tail_offset: int  # byte offset of the verbatim tail
    section_bytes: int = 0  # lowdim: EB bytes a (block, dim); 0: row-major


def _index(walk, elem_sz: int, lowdim: bool) -> StreamIndex:
    widths, offsets, out_rows, row_bytes, total_rows, tail_offset = walk
    return StreamIndex(
        widths=widths, payload_offsets=offsets, out_rows=out_rows,
        row_bytes=row_bytes, total_rows=total_rows, tail_offset=tail_offset,
        section_bytes=8 * elem_sz if lowdim else 0)


def _count_walk(walk, idx: StreamIndex) -> StreamIndex:
    """Count a walk's data and run blocks into ``walk``'s counters."""
    ndata = idx.widths.shape[0]
    trace.count(walk, data_blocks=ndata,
                run_blocks=idx.total_rows // BLOCK_SZ - ndata)
    return idx


def walk_headers(buf: bytes, ngroups: int, ndims: int, elem_sz: int,
                 lowdim: bool = False, start: int = METADATA_LEN_RLE,
                 runs: bool = True) -> StreamIndex:
    """Sequential walk over ``ngroups`` group headers from byte ``start``
    (right after the stream's metadata, or a sidecar's checkpoint; rows
    count from there) to index payloads and runs, in the port's host
    library (``native_host.walk_headers``). A data block's payload is 8
    rows of ceil(sum(w) / 8) bytes, or sum(w) bytes in the lowdim layout
    (each dim's 8 fields of w bits are w bytes). ``runs=False`` walks a
    non-RLE stream (``simple.py``): a block of all-zero widths is a data
    block of width 0 with no payload. ``_walk_headers_py`` is its plain
    version."""
    with annotate("decode.walk"):
        idx = _index(native_host.walk_headers(buf, ngroups, ndims, elem_sz,
                                              lowdim, start, runs),
                     elem_sz, lowdim)
    return _count_walk(walk_headers, idx)


def walk_headers_parallel(buf: bytes, ngroups: int, ndims: int,
                          elem_sz: int, byte_offsets: np.ndarray,
                          row_offsets: np.ndarray, every_groups: int,
                          lowdim: bool = False) -> StreamIndex:
    """``walk_headers`` of the whole stream, split at a sidecar's
    checkpoints: segment s walks ``every_groups`` groups from
    ``byte_offsets[s]`` with rows from ``row_offsets[s]``, the segments on
    threads of the host library (``native_host.walk_headers_parallel``).
    A sidecar of one checkpoint, or a stream of at most ``every_groups``
    groups, takes the serial walk, as the JAX package's
    ``decoder.walk_headers_parallel`` does. Raises ``CorruptStreamError``
    where a segment's rows do not end at the next segment's first row.
    ``_walk_headers_parallel_py`` is its plain version."""
    if len(byte_offsets) <= 1 or ngroups <= every_groups:
        return walk_headers(buf, ngroups, ndims, elem_sz, lowdim)
    with annotate("decode.walk"):
        idx = _index(native_host.walk_headers_parallel(
            buf, byte_offsets, row_offsets, every_groups, ngroups, ndims,
            elem_sz, lowdim), elem_sz, lowdim)
    return _count_walk(walk_headers_parallel, idx)


def _walk_headers_parallel_py(buf: bytes, ngroups: int, ndims: int,
                              elem_sz: int, byte_offsets: np.ndarray,
                              row_offsets: np.ndarray, every_groups: int,
                              lowdim: bool = False) -> StreamIndex:
    """``walk_headers_parallel``'s plain version: the plain serial walk of
    each segment, one after another, then the segments' rows checked
    against the sidecar's and the indexes joined."""
    if len(byte_offsets) <= 1 or ngroups <= every_groups:
        return _walk_headers_py(buf, ngroups, ndims, elem_sz, lowdim)
    parts = []
    for s, start in enumerate(byte_offsets):
        g0 = min(s * every_groups, ngroups)
        parts.append(_walk_headers_py(
            buf, min(g0 + every_groups, ngroups) - g0, ndims, elem_sz, lowdim,
            int(start)))
    for s, part in enumerate(parts[:-1]):
        if row_offsets[s] + part.total_rows != row_offsets[s + 1]:
            raise CorruptStreamError(
                f"sidecar inconsistent with stream at checkpoint {s}: "
                f"segment rows {part.total_rows} != recorded row span")
    return StreamIndex(
        widths=np.concatenate([p.widths for p in parts]),
        payload_offsets=np.concatenate([p.payload_offsets for p in parts]),
        out_rows=np.concatenate([p.out_rows + int(row_offsets[s])
                                 for s, p in enumerate(parts)]),
        row_bytes=np.concatenate([p.row_bytes for p in parts]),
        total_rows=int(row_offsets[-1]) + parts[-1].total_rows,
        tail_offset=parts[-1].tail_offset,
        section_bytes=parts[0].section_bytes)


def _walk_headers_py(buf: bytes, ngroups: int, ndims: int, elem_sz: int,
                     lowdim: bool = False, start: int = METADATA_LEN_RLE,
                     runs: bool = True) -> StreamIndex:
    """``walk_headers``' plain version: a Python loop over the groups."""
    hdr_bits = nbits_sz_bits(elem_sz)
    elem_bits = 8 * elem_sz
    total_header_bytes = (ndims * hdr_bits * GROUP_SZ_BLOCKS + 7) // 8

    widths_list = []
    offsets = []
    out_rows = []
    pos = start
    row = 0
    buf_len = len(buf)
    buf_np = np.frombuffer(buf, dtype=np.uint8)

    def _overrun(what: str):
        raise CorruptStreamError(
            f"stream walk overran the buffer reading {what} at byte {pos} "
            f"(len {buf_len}): truncated stream or inconsistent metadata")

    for _g in range(ngroups):
        if pos + total_header_bytes > buf_len:
            _overrun("a group header")
        hdr = unpack_headers(
            buf_np[pos : pos + total_header_bytes][None, :], 1, ndims, hdr_bits)
        pos += total_header_bytes
        group_widths = header_to_width(hdr.astype(np.int64), elem_bits)
        for w in group_widths:
            wsum = int(w.sum())
            if wsum == 0 and runs:
                if pos >= buf_len:
                    _overrun("a run varint")
                low = buf[pos]
                pos += 1
                length = low & 0x7F
                if low & 0x80:
                    if pos >= buf_len:
                        _overrun("a 2-byte run varint")
                    length |= buf[pos] << 7
                    pos += 1
                row += length * BLOCK_SZ
                continue
            widths_list.append(w)
            offsets.append(pos)
            out_rows.append(row)
            pos += wsum if lowdim else BLOCK_SZ * ((wsum + 7) // 8)
            if pos > buf_len:
                _overrun("a block payload")
            row += BLOCK_SZ
    ndata = len(widths_list)
    widths = (np.stack(widths_list).astype(np.uint8)
              if ndata else np.zeros((0, ndims), np.uint8))
    return StreamIndex(
        widths=widths,
        payload_offsets=np.asarray(offsets, dtype=np.int64),
        out_rows=np.asarray(out_rows, dtype=np.int64),
        row_bytes=((widths.sum(axis=1, dtype=np.int64) + 7) // 8).astype(
            np.int32),
        total_rows=row,
        tail_offset=pos,
        section_bytes=8 * elem_sz if lowdim else 0,
    )


def stream_maxb(idx: StreamIndex) -> int:
    """The row-major stream's widest payload row in bytes, at least 1."""
    return max(int(idx.row_bytes.max()) if idx.row_bytes.size else 1, 1)


def gather_payloads(buf: bytes, idx: StreamIndex, maxb: int | None = None,
                    out: np.ndarray | None = None) -> np.ndarray:
    """Gather the packed payload rows into a dense (ndata, 8, MAXB) uint8
    buffer, zero padded, in the port's host library; MAXB is ``maxb`` or
    the stream's widest row in bytes (``stream_maxb``), not a bucket. In
    the lowdim layout the (block, dim) sections go into a dense
    (ndata, D, EB) buffer, zero past each section's w bytes. ``out``: the
    buffer to gather into (a batch's slice), else a new one.
    ``_gather_payloads_py`` is its plain version."""
    with annotate("decode.gather"):
        if idx.section_bytes:
            dense = native_host.gather_dims(buf, idx.payload_offsets,
                                            idx.widths, idx.section_bytes,
                                            out)
        else:
            dense = native_host.gather_blocks(
                buf, idx.payload_offsets, idx.row_bytes,
                stream_maxb(idx) if maxb is None else maxb, out)
    trace.count(gather_payloads, bytes=dense.nbytes)
    return dense


def _gather_payloads_py(buf: bytes, idx: StreamIndex) -> np.ndarray:
    """``gather_payloads``' plain version: numpy index arithmetic."""
    ndata = idx.widths.shape[0]
    if idx.section_bytes:
        ndims = idx.widths.shape[1]
        dense = np.zeros((ndata, ndims, idx.section_bytes), dtype=np.uint8)
        w = idx.widths.astype(np.int64)
        unit_src = (np.repeat(idx.payload_offsets, ndims)
                    + (np.cumsum(w, axis=1) - w).reshape(-1))
        unit_dst = np.arange(ndata * ndims, dtype=np.int64) * dense.shape[2]
        copy_ranges(dense.reshape(-1), unit_dst, np.frombuffer(buf, np.uint8),
                    unit_src, w.reshape(-1))
        return dense
    rb = ((idx.widths.sum(axis=1, dtype=np.int64) + 7) // 8)
    maxb = max(int(rb.max()) if ndata else 1, 1)
    dense = np.zeros((ndata, BLOCK_SZ, maxb), dtype=np.uint8)
    unit_len = np.repeat(rb, BLOCK_SZ)
    unit_src = (np.repeat(idx.payload_offsets, BLOCK_SZ)
                + np.tile(np.arange(BLOCK_SZ), ndata) * unit_len)
    unit_dst = np.arange(ndata * BLOCK_SZ, dtype=np.int64) * maxb
    copy_ranges(dense.reshape(-1), unit_dst, np.frombuffer(buf, np.uint8),
                unit_src, unit_len)
    return dense


def place_blocks(dense: torch.Tensor, widths: torch.Tensor,
                 out_rows: torch.Tensor, total_rows: int):
    """The data blocks' payload and widths placed on the block timeline of
    ``total_rows`` rows: a run block gets width 0 and zero bytes. Returns
    them as they are where there are no runs."""
    ndata, ndims = widths.shape
    if total_rows == ndata * BLOCK_SZ:
        return dense, widths
    src = torch.full((total_rows // BLOCK_SZ,), ndata, dtype=torch.int64,
                     device=dense.device)
    src[out_rows // BLOCK_SZ] = torch.arange(ndata, device=dense.device)
    return (torch.cat([dense, dense.new_zeros((1,) + dense.shape[1:])])[src],
            torch.cat([widths, widths.new_zeros((1, ndims))])[src])


def fire_errors(dense: torch.Tensor, widths: torch.Tensor, elem_sz: int,
                lowdim: bool) -> torch.Tensor:
    """The timeline's zigzag errors (rows, D) in the FIRE decode's types:
    K4 (K5, its narrow mode, at u8) or the lowdim decode's raw mode."""
    if lowdim:
        errs = unpack_dims_lowdim(dense, widths)
    else:
        errs = unpack_rows(dense, widths, narrow=elem_sz == 1)
    return errs.reshape(-1, widths.shape[1])


@annotate("decode.device")
def decode_device(dense: torch.Tensor, widths: torch.Tensor,
                  out_rows: torch.Tensor, total_rows: int,
                  elem_sz: int, codec: str = "delta",
                  lowdim: bool = False, chunks=None, init_state=None,
                  final: bool = False):
    """Device pass: the gathered payload of the data blocks -> the stream's
    rows (total_rows, D), u8/u16, on the payload's device.

    dense (ndata, 8, MAXB) uint8, or (ndata, D, EB) with ``lowdim``;
    widths (ndata, D) uint8; out_rows (ndata,) int64 first row of each
    data block on the timeline.

    ``chunks``: None, or (first_block, states) to decode the timeline as
    chunks that each start from a state of their own: first_block the
    chunks' first blocks (C,), rising from 0, on the host; states
    (C, S, D) int32, S 3 for FIRE and 1 (or more; row 0 is used) for
    delta. Chunk c runs to the next chunk's first block, the last to the
    end of the timeline.

    ``init_state``, ``final``: FIRE's carry (xff, without ``chunks``), as
    ``fire_decode`` takes and returns it: the (3, D) state entering the
    first block, and with ``final`` the values come with the state after
    the last block, left on the device.

    With runs, the payload blocks are first placed on the block timeline
    (runs are whole blocks, so every block start is 8-aligned): a run
    block gets width 0 and zero bytes, which unpack to zero errors, which
    is exactly what a run is (for FIRE too: a block is a run block when its
    errors under the forecaster's state are all zero). Run-free streams
    and streams with runs then take the same kernels.
    """
    ndims = widths.shape[1]
    if (init_state is not None or final) and (codec != "xff"
                                              or chunks is not None):
        raise ValueError("init_state and final take FIRE without chunks")
    dense, widths = place_blocks(dense, widths, out_rows, total_rows)
    if chunks is not None:
        first = np.append(np.asarray(chunks[0], dtype=np.int64),
                          total_rows // BLOCK_SZ)
        states = np.asarray(chunks[1], dtype=np.int32)
    if codec == "xff":
        errs = fire_errors(dense, widths, elem_sz, lowdim)
        if chunks is not None:
            return fire_decode_chunks(errs, 8 * elem_sz, first, states,
                                      truncate_coeffs=not lowdim)
        return fire_decode(errs, 8 * elem_sz, init_state=init_state,
                           truncate_coeffs=not lowdim, final=final)
    ck = None if chunks is None else delta_chunks(
        first, states[:, 0], total_rows // BLOCK_SZ, ndims, dense.device)
    if lowdim:
        return decode_delta_lowdim(dense, widths, 8 * elem_sz, ck)
    return decode_delta_contiguous(dense, widths, 8 * elem_sz, ck)


# The pipeline of ``decompress``: an xff stream decodes in equal segments
# of whole groups. A segment costs the host about a millisecond of calls of
# its own on an H100 machine (launches, copies, events), and it gains its
# host work (the walk and gather of its bytes, 4-8 ns a byte there), which
# runs under the chain of the segment before. So a segment holds at least
# PIPE_BYTES of the stream (1-1.5 ms of that work) and PIPE_GROUPS groups
# (0.45 ms of FIRE's chain or more: a group has 16 rows or more), and there
# are at most PIPE_SEGMENTS. Delta's device pass takes microseconds and
# hides nothing: one segment.
PIPE_BYTES = 192 << 10
PIPE_GROUPS = 4096
PIPE_SEGMENTS = 8


def segment_plan(codec: str, ngroups: int, nbytes: int) -> list[int]:
    """The groups of each of ``decompress``'s segments, in stream order,
    for a stream of ``ngroups`` groups in ``nbytes`` bytes."""
    n = (min(PIPE_SEGMENTS, nbytes // PIPE_BYTES, ngroups // PIPE_GROUPS)
         if codec == "xff" else 1)
    n = max(n, 1)
    return [ngroups // n + (i < ngroups % n) for i in range(n)]


def decompress(buf: bytes, codec: str = "delta", elem_sz: int = 1,
               device: str | torch.device | None = None) -> np.ndarray:
    """Decompress a delta or FIRE stream, either layout; returns the flat
    elements. The stream does not record its codec: ``codec`` must be the
    one it was compressed with.

    ``device``: where the device pass runs, CUDA by default (raises when
    CUDA is absent); ``"cpu"`` runs the kernels' plain versions (tests).

    The stream decodes in segments of whole groups (``segment_plan``):
    while the card decodes one, the host walks and gathers the next (the
    module's docstring). FIRE's chain runs across them unbroken, carried on
    the card, so the values are those of one pass.

    The array returned is a view of a block of host memory that the module
    recycles (``_room``): its values, dtype, flat shape and writability are
    a fresh array's, but it does not own its data (``flags.owndata`` is
    False). The block goes back to the pool when the last array over it
    dies, never before.
    """
    if codec not in ("delta", "xff"):
        raise ValueError(f"codec must be 'delta' or 'xff', got {codec!r}")
    if elem_sz not in (1, 2):
        raise ValueError(f"elem_sz must be 1 or 2, got {elem_sz}")
    dev = resolve_device(device)
    udt = np.uint8 if elem_sz == 1 else np.uint16
    if len(buf) < METADATA_LEN_RLE:
        raise CorruptStreamError(
            f"stream shorter than its {METADATA_LEN_RLE}-byte metadata "
            f"({len(buf)} bytes)")
    ngroups, remaining_len, ndims = read_metadata_rle(buf)
    if ndims == 0 and not (ngroups == 0 and remaining_len == 0):
        raise CorruptStreamError("metadata declares 0 dims")
    if ngroups == 0 and remaining_len < MIN_DATA_SIZE:
        if len(buf) < METADATA_LEN_RLE + remaining_len * elem_sz:
            raise CorruptStreamError("verbatim stream truncated")
        return np.frombuffer(
            buf, dtype=udt, count=remaining_len,
            offset=METADATA_LEN_RLE).copy()
    lowdim = ndims <= LOWDIM_MAX_NDIMS[elem_sz]
    plan = segment_plan(codec, ngroups, len(buf))
    trace.count(decompress, segments=len(plan))
    chained = len(plan) > 1
    pipe = _pipe(dev)
    out = carry = pending = None
    start, row, walked = METADATA_LEN_RLE, 0, 0
    for k, groups in enumerate(plan):
        idx = walk_headers(buf, groups, ndims, elem_sz, lowdim, start)
        start, walked = idx.tail_offset, walked + groups
        rows = row + idx.total_rows
        if walked == ngroups and start + remaining_len * elem_sz > len(buf):
            raise CorruptStreamError(
                f"verbatim tail truncated: need "
                f"{start + remaining_len * elem_sz} bytes, have {len(buf)}")
        need = rows * ndims + remaining_len
        out = _room(out, need, need if walked == ngroups else
                    -(-rows * ngroups * 9 // (8 * walked)) * ndims
                    + remaining_len, udt)
        got = None
        if idx.total_rows:
            up_slot, down_slot = ((None, None) if pipe is None
                                  else (pipe.up[k % 2], pipe.down[k % 2]))
            dense = gather_payloads(buf, idx, out=None if pipe is None
                                    else staged_payload(up_slot, idx))
            vals = decode_device(
                *upload_payload(dense, idx, dev, slot=up_slot),
                idx.total_rows, elem_sz, codec, lowdim, init_state=carry,
                final=chained)
            if chained:
                vals, carry = vals
            got = (vals if pipe is None else queue_download(vals, down_slot),
                   row * ndims, rows * ndims)
        if pending is not None:
            _join(out, *pending)
        pending, row = got, rows
    vals, at, end = pending or (None, 0, 0)
    return _join(out, vals, at, end, tail=(row * ndims, np.frombuffer(
        buf, dtype=udt, count=remaining_len, offset=start)))


# The blocks of host memory that ``decompress``'s results are carved from
# (``_room``). A result of tens of megabytes lies above glibc's largest mmap
# threshold (32 MB), so a fresh array of it is mapped anew on every call,
# and its first touches, inside the join's copy, cost more than the copy.
# A block whose last array has died serves a later call with its pages
# mapped. At most OUT_FREE_BLOCKS free blocks wait; the rest go back to the
# allocator. A copy of THREAD_COPY_BYTES or more (two of the host library's
# 2 MiB grains) runs on the library's threads: into a recycled block up to
# the host's cores, into a fresh one up to FRESH_COPY_THREADS, past which
# its first touches contend. On the host of an H100 machine
# (probes/join_probe.py, 57,548,800 bytes) a fresh block took 25-27 ms on
# numpy's one thread, 12-14 on 4 threads and 13-16 on 8; a recycled one
# 14-15, 4.9-5.4 and 4.1-4.4. A smaller copy would run on one thread there
# anyway, and numpy's is the cheaper: through the library the FIRE decodes'
# 0.5-2.1 MB segments cost 0.8-1.8% of their calls.
OUT_FREE_BLOCKS = 2
THREAD_COPY_BYTES = 4 << 20
FRESH_COPY_THREADS = 4


class _OutPool:
    """``_room``'s blocks: plain pageable uint8 arrays, process-wide. A
    block comes back (``give``) from whatever thread drops the last array
    over it, the garbage collector's included, which may run inside
    ``take`` on the thread that holds the lock: so ``give`` queues it
    without waiting for the lock, and whoever holds the lock files the
    queue on the way out (``_settle``)."""

    def __init__(self, keep: int):
        self.keep = keep
        self.free: list[np.ndarray] = []  # the newest last
        self._back: collections.deque[np.ndarray] = collections.deque()
        self._lock = threading.Lock()

    def take(self, need: int, want: int) -> np.ndarray | None:
        """The smallest free block of ``need`` to ``2 * want`` bytes, taken
        out of the pool; None where there is none."""
        with self._lock:
            self._file()
            sizes = [b.nbytes for b in self.free]
            fit = min((i for i, n in enumerate(sizes)
                       if need <= n <= 2 * want),
                      key=sizes.__getitem__, default=None)
            block = None if fit is None else self.free.pop(fit)
        self._settle()
        return block

    def give(self, block: np.ndarray) -> None:
        self._back.append(block)
        self._settle()

    def _settle(self) -> None:
        while self._back and self._lock.acquire(blocking=False):
            try:
                self._file()
            finally:
                self._lock.release()

    def _file(self) -> None:
        """Under the lock: the blocks given back into the free list, and
        all but the newest ``keep`` dropped."""
        while self._back:
            self.free.append(self._back.popleft())
        del self.free[:max(len(self.free) - self.keep, 0)]


_OUT = _OutPool(OUT_FREE_BLOCKS)


class _Lease:
    """A block of the pool handed out: the array over it (``np.asarray``
    of the lease) and every view of that array hold the lease as their
    base, and the lease gives the block back when the last of them dies.
    ``recycled``: the block came from the pool, so its pages are mapped."""

    __slots__ = ("block", "dtype", "recycled", "pool")

    def __init__(self, block: np.ndarray, dtype, recycled: bool):
        self.block, self.dtype = block, np.dtype(dtype)
        self.recycled, self.pool = recycled, _OUT

    @property
    def __array_interface__(self):
        return {"shape": (self.block.nbytes // self.dtype.itemsize,),
                "typestr": self.dtype.str, "version": 3,
                "data": (self.block.__array_interface__["data"][0], False)}

    def __del__(self):
        self.pool.give(self.block)


def _room(out: np.ndarray | None, need: int, guess: int,
          dtype) -> np.ndarray:
    """``out``, or a larger array holding its elements, of at least
    ``need`` elements and of ``guess`` where it must grow (``decompress``:
    the rows so far scaled to all the stream's groups, and an eighth more,
    so that a stream whose later segments hold more rows grows seldom; it
    cuts the array to size at the end). A grown array lies over a block of
    the pool (``_OutPool.take``: up to twice the bytes asked for), or over
    a fresh block of exactly those bytes; it counts the block's bytes in
    ``recycled_bytes`` or ``fresh_bytes``."""
    if out is not None and out.size >= need:
        return out
    item = np.dtype(dtype).itemsize
    want = max(need, guess) * item
    block = _OUT.take(need * item, want)
    recycled = block is not None
    if recycled:
        trace.count(_room, recycled_bytes=block.nbytes)
    else:
        block = np.empty(want, np.uint8)
        trace.count(_room, fresh_bytes=want)
    grown = np.asarray(_Lease(block, dtype, recycled))
    if out is not None:
        _copy(grown[:out.size], out)
    return grown


def _copy(dst: np.ndarray, src: np.ndarray) -> None:
    """``dst[...] = src`` into a part of a ``_room`` array: from
    ``THREAD_COPY_BYTES`` on, on the host library's threads
    (``native_host.copy``: one a 2 MiB at least), up to the host's cores
    where its block was recycled and up to ``FRESH_COPY_THREADS`` where it
    is fresh; below, numpy's copy."""
    if dst.nbytes < THREAD_COPY_BYTES:
        dst[...] = src
        return
    lease = dst.base
    while isinstance(lease, np.ndarray):  # views keep their array as base
        lease = lease.base
    native_host.copy(dst, np.ascontiguousarray(src),
                     64 if getattr(lease, "recycled", False)
                     else FRESH_COPY_THREADS)


def _join(out: np.ndarray, vals, at: int, end: int,
          tail=None) -> np.ndarray:
    """A segment's values (on the device, or a ``queue_download``; None:
    none) into ``out[at:end]``; with ``tail``, (the element after the
    stream's last row, its verbatim tail), the tail there too. Returns
    ``out``, with ``tail`` the view of it that ends with the tail; counts
    the bytes it writes there (``bytes``)."""
    if vals is not None:
        vals = download_values(vals)
    with annotate("decode.join"):
        got = 0 if vals is None else vals.size
        if got:
            _copy(out[at:at + got], vals)
            trace.count(_join, bytes=vals.nbytes)
        # a recycled block holds an earlier result: values that come up
        # short leave zeros there, as fresh pages would, never its values
        out[at + got:end] = 0
        if tail is not None:
            at, tail = tail
            out = out[:at + tail.size]
            out[at:] = tail
            trace.count(_join, bytes=tail.nbytes)
    return out


class _Slot:
    """A pinned host buffer that one copy at a time goes through on
    ``stream``, grown to the largest copy it has carried (to a power of
    two), and the event that marks its last copy's end."""

    def __init__(self, stream: torch.cuda.Stream):
        self.stream = stream
        self.buf: torch.Tensor | None = None
        self.done = torch.cuda.Event()

    def take(self, nbytes: int) -> torch.Tensor:
        """The buffer's first ``nbytes``, once its last copy is over."""
        self.wait()
        if self.buf is None or self.buf.numel() < nbytes:
            self.buf = None
            self.buf = torch.empty(1 << max(nbytes - 1, 0).bit_length(),
                                   dtype=torch.uint8, pin_memory=True)
            trace.count(_Slot.take, pinned_allocs=1)
        return self.buf[:nbytes]

    def wait(self) -> None:
        self.done.synchronize()


class _Pipe:
    """``decompress``'s copies on one CUDA device, for one thread: two
    pinned upload slots on an upload stream and two pinned download slots
    on a download stream, segment k in slots k % 2, so that neither copy
    queues behind the chain on the compute stream."""

    def __init__(self, device: torch.device):
        up, down = torch.cuda.Stream(device), torch.cuda.Stream(device)
        self.up = (_Slot(up), _Slot(up))
        self.down = (_Slot(down), _Slot(down))


_pipes = threading.local()


def _pipe(device: torch.device) -> _Pipe | None:
    """This thread's ``_Pipe`` on ``device``; None off CUDA."""
    if device.type != "cuda":
        return None
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    by_device = _pipes.__dict__.setdefault("by_device", {})
    if index not in by_device:
        by_device[index] = _Pipe(torch.device("cuda", index))
    return by_device[index]


# the parts of an upload slot start aligned as tensors of their own would
# (the unpack kernels load 16 bytes at a time)
_ALIGN = 256


def _staging(idx: StreamIndex):
    """An upload slot's layout for a walk: (payload shape, byte offset of
    the first rows, how many go up, byte offset of the widths, total
    bytes), the payload first. The first rows go up only where the walk
    has runs: ``place_blocks`` reads them only there."""
    ndata, ndims = idx.widths.shape
    shape = ((ndata, ndims, idx.section_bytes) if idx.section_bytes
             else (ndata, BLOCK_SZ, stream_maxb(idx)))
    nrows = ndata if idx.total_rows != ndata * BLOCK_SZ else 0
    rows_at = -(-math.prod(shape) // _ALIGN) * _ALIGN
    widths_at = -(-(rows_at + 8 * nrows) // _ALIGN) * _ALIGN
    return shape, rows_at, nrows, widths_at, widths_at + ndata * ndims


def staged_payload(slot: _Slot, idx: StreamIndex) -> np.ndarray:
    """The walk's payload buffer at the start of an upload slot (the
    ``out`` of ``gather_payloads``), which then has room for its widths
    and first rows (``upload_payload(..., slot=slot)``)."""
    shape, _, _, _, total = _staging(idx)
    return slot.take(total)[:math.prod(shape)].numpy().reshape(shape)


def decompress_batch(bufs: list[bytes], codec: str = "delta",
                     elem_sz: int = 1,
                     device: str | torch.device | None = None
                     ) -> list[np.ndarray]:
    """Decompress S streams in one device pass; returns each stream's flat
    elements, as ``decompress`` would. The counterpart of the JAX package's
    ``decoder.decompress_batch``, whose two vmapped passes become one
    ``decode_device`` over the streams' timelines laid end to end, each
    stream a chunk from the zero state: one set of launches for the batch,
    with runs or without, in either layout and codec.

    The streams that share the first stream's ndims and have rows are
    walked and gathered on the host (row-major payloads padded to the
    batch's widest row), go up in one copy and come down in one; each
    stream's verbatim tail is appended on the host. Short (verbatim)
    streams are read on the host, and streams without rows, or of another
    ndims, take ``decompress`` one by one, as in the JAX package (which
    walks a stream of another ndims with the first stream's, and may raise
    for it; the port does not). Raises ``CorruptStreamError`` for a
    truncated or inconsistent stream."""
    if codec not in ("delta", "xff"):
        raise ValueError(f"codec must be 'delta' or 'xff', got {codec!r}")
    if elem_sz not in (1, 2):
        raise ValueError(f"elem_sz must be 1 or 2, got {elem_sz}")
    dev = resolve_device(device)
    if not bufs:
        return []
    udt = np.uint8 if elem_sz == 1 else np.uint16
    for buf in bufs:
        if len(buf) < METADATA_LEN_RLE:
            raise CorruptStreamError(
                f"stream shorter than its {METADATA_LEN_RLE}-byte metadata "
                f"({len(buf)} bytes)")
    metas = [read_metadata_rle(b) for b in bufs]
    ndims = metas[0][2]
    lowdim = ndims <= LOWDIM_MAX_NDIMS[elem_sz]
    out: list[np.ndarray | None] = [None] * len(bufs)
    batch = []  # (stream, its walk, its verbatim tail)
    for i, (buf, (ngroups, remaining_len, nd)) in enumerate(zip(bufs, metas)):
        if ngroups == 0 and remaining_len < MIN_DATA_SIZE:
            if len(buf) < METADATA_LEN_RLE + remaining_len * elem_sz:
                raise CorruptStreamError("verbatim stream truncated")
            out[i] = np.frombuffer(buf, dtype=udt, count=remaining_len,
                                   offset=METADATA_LEN_RLE).copy()
            continue
        if nd != ndims:
            out[i] = decompress(buf, codec, elem_sz, dev)
            continue
        idx = walk_headers(buf, ngroups, ndims, elem_sz, lowdim)
        if idx.tail_offset + remaining_len * elem_sz > len(buf):
            raise CorruptStreamError(
                f"verbatim tail truncated: need "
                f"{idx.tail_offset + remaining_len * elem_sz} bytes, "
                f"have {len(buf)}")
        if idx.total_rows == 0:
            out[i] = decompress(buf, codec, elem_sz, dev)
            continue
        batch.append((i, idx, np.frombuffer(buf, dtype=udt,
                                            count=remaining_len,
                                            offset=idx.tail_offset)))
    if batch:
        dense, widths, out_rows, starts = gather_batch(
            bufs, batch, ndims, elem_sz, lowdim)
        up = upload_batch(dense, widths, out_rows, dev)
        vals = download_values(decode_batch(*up, starts, elem_sz, codec,
                                            lowdim))
        for (i, idx, tail), row in zip(batch, starts):
            body = vals[row * ndims:(row + idx.total_rows) * ndims]
            out[i] = join_tail(body, tail)
    return out


def gather_batch(bufs: list[bytes], batch, ndims: int, elem_sz: int,
                 lowdim: bool):
    """A batch's payloads on the host: each (stream, walk, tail) of
    ``batch`` gathered into one buffer (row-major rows padded to the
    batch's widest), its timeline after the previous stream's ->
    (dense, widths, out_rows, starts): starts (S + 1,) the streams' first
    rows on the joined timeline and its total."""
    ndata = [idx.widths.shape[0] for _, idx, _ in batch]
    starts = np.cumsum([0] + [idx.total_rows for _, idx, _ in batch])
    if lowdim:
        inner = (ndims, 8 * elem_sz)
    else:
        inner = (BLOCK_SZ, max(stream_maxb(idx) for _, idx, _ in batch))
    dense = np.empty((sum(ndata),) + inner, dtype=np.uint8)
    at = np.cumsum([0] + ndata)
    for s, (i, idx, _) in enumerate(batch):
        gather_payloads(bufs[i], idx, inner[1], dense[at[s]:at[s + 1]])
    widths = np.concatenate([idx.widths for _, idx, _ in batch])
    out_rows = np.concatenate([idx.out_rows + starts[s]
                               for s, (_, idx, _) in enumerate(batch)])
    return dense, widths, out_rows, starts


def decode_batch(dense: torch.Tensor, widths: torch.Tensor,
                 out_rows: torch.Tensor, starts: np.ndarray, elem_sz: int,
                 codec: str, lowdim: bool) -> torch.Tensor:
    """A batch's device pass: one ``decode_device`` over the joined
    timeline, a chunk a stream (from ``starts``, on the host) from the
    zero state -> the streams' rows end to end."""
    states = np.zeros((starts.size - 1, 3, widths.shape[1]), np.int32)
    return decode_device(dense, widths, out_rows, int(starts[-1]), elem_sz,
                         codec, lowdim,
                         chunks=(starts[:-1] // BLOCK_SZ, states))


def decode_indexed(buf: bytes, idx: StreamIndex, ndims: int, elem_sz: int,
                   codec: str, init_state: np.ndarray | None = None,
                   device: str | torch.device | None = None) -> np.ndarray:
    """Decode the rows a walk indexed (a walk that may start mid-stream, at
    a sidecar's checkpoint) from ``init_state``, the (S, D) state entering
    its first block (FIRE's (3, D) carry, delta's (1, D) previous row;
    zeros when None) -> (rows, D) u8/u16, without the verbatim tail. The
    counterpart of the JAX package's ``decoder.decode_indexed`` (the walk
    tells the layout); the device pass is ``decode_device``'s, as one
    chunk."""
    dev = resolve_device(device)
    udt = np.uint8 if elem_sz == 1 else np.uint16
    if idx.total_rows == 0:
        return np.zeros((0, ndims), udt)
    state = np.zeros((3, ndims), np.int32)
    if init_state is not None:
        init_state = np.asarray(init_state, dtype=np.int32)
        state[: init_state.shape[0]] = init_state
    vals = decode_device(*upload_payload(gather_payloads(buf, idx), idx, dev),
                         idx.total_rows, elem_sz, codec, idx.section_bytes > 0,
                         chunks=(np.zeros(1, np.int64), state[None]))
    return download_values(vals).reshape(-1, ndims)


def _upload(counted, device: torch.device, *arrays: np.ndarray):
    """Host arrays -> tensors on ``device``, counted in ``counted``'s
    transfer counters."""
    with annotate("decode.upload"):
        up = tuple(torch.from_numpy(a).to(device) for a in arrays)
    trace.count_transfer(counted, device, *arrays)
    return up


def upload_payload(dense: np.ndarray, idx: StreamIndex, device: torch.device,
                   slot: _Slot | None = None):
    """Host payload and index -> (dense u8, widths u8, out_rows int64) on
    ``device``.

    ``slot``: an upload slot whose ``staged_payload`` ``dense`` is. The
    widths and first rows join the payload there, the three go up in one
    copy on the slot's stream, and the current stream waits for it."""
    if slot is None:
        return _upload(upload_payload, device, dense, idx.widths, idx.out_rows)
    shape, rows_at, nrows, widths_at, total = _staging(idx)
    if dense.shape != shape or (dense.size and dense.ctypes.data
                                != slot.buf.data_ptr()):
        raise ValueError("upload_payload(slot=) takes the slot's "
                         "staged_payload")
    ndata, ndims = idx.widths.shape
    with annotate("decode.upload"):
        host = slot.buf[:total]
        flat = host.numpy()
        flat[rows_at:rows_at + 8 * nrows].view(np.int64)[:] = \
            idx.out_rows[:nrows]
        flat[widths_at:] = idx.widths.reshape(-1)
        compute = torch.cuda.current_stream(device)
        with torch.cuda.stream(slot.stream):
            up = torch.empty(total, dtype=torch.uint8, device=device)
            up.copy_(host, non_blocking=True)
            slot.done.record()
        compute.wait_event(slot.done)
        up.record_stream(compute)
    trace.count_transfer(upload_payload, device, host)
    return (up[:dense.nbytes].view(shape),
            up[widths_at:].view(ndata, ndims),
            up[rows_at:rows_at + 8 * nrows].view(torch.int64))


def upload_batch(dense: np.ndarray, widths: np.ndarray, out_rows: np.ndarray,
                 device: torch.device):
    """``upload_payload`` of a batch's joined payload and index
    (``gather_batch``)."""
    return _upload(upload_batch, device, dense, widths, out_rows)


@dataclasses.dataclass
class Queued:
    """A download queued through a pinned slot (``queue_download``): the
    values land in ``host`` once the slot's copy is done."""

    host: np.ndarray
    slot: _Slot


def queue_download(vals: torch.Tensor, slot: _Slot) -> Queued:
    """Queue the copy of (rows, D) u8/u16 device values into a download
    slot, on its stream behind the current stream's work so far;
    ``download_values`` of the result waits for it."""
    with annotate("decode.download"):
        host = slot.take(vals.nbytes)
        slot.done.record(torch.cuda.current_stream(vals.device))
        slot.stream.wait_event(slot.done)
        with torch.cuda.stream(slot.stream):
            host.copy_(vals.reshape(-1).view(torch.uint8), non_blocking=True)
            slot.done.record()
        vals.record_stream(slot.stream)
    trace.count_transfer(download_values, vals.device, host)
    return Queued(host.numpy().view(np.uint16 if vals.dtype == torch.uint16
                                    else np.uint8), slot)


def download_values(vals: torch.Tensor | Queued) -> np.ndarray:
    """(rows, D) u8/u16 device values -> flat numpy array. u16 travels as
    int16 (torch's uint16 is a storage type) and is reinterpreted. A
    ``Queued`` download -> its values once they have landed (a view of
    its pinned slot, until the slot's next copy)."""
    if isinstance(vals, Queued):
        with annotate("decode.download"):
            vals.slot.wait()
        return vals.host
    with annotate("decode.download"):
        if vals.dtype == torch.uint16:
            out = vals.view(torch.int16).cpu().numpy().view(np.uint16)
        else:
            out = vals.cpu().numpy()
    trace.count_transfer(download_values, vals.device, out)
    return out.reshape(-1)


def join_tail(values: np.ndarray, tail: np.ndarray) -> np.ndarray:
    """A decode's flat values followed by the stream's verbatim tail."""
    with annotate("decode.join"):
        return np.concatenate([values, tail])


for _fn in (walk_headers, walk_headers_parallel):
    trace.count(_fn, data_blocks=0, run_blocks=0)
trace.count(decompress, segments=0)
trace.count(_Slot.take, pinned_allocs=0)
trace.count(gather_payloads, bytes=0)
trace.count(_join, bytes=0)
trace.count(_room, fresh_bytes=0, recycled_bytes=0)
for _fn in (upload_payload, upload_batch, download_values):
    trace.count(_fn, pageable_bytes=0, pinned_bytes=0)
