"""The port's host runtime (``csrc/sprintz_host.cpp``), built with g++ and
bound with ctypes.

The stream format's per-block bookkeeping runs on the host whatever the
device: the decode's header walk (serial, or split at a sidecar's
checkpoints over threads) and payload gather, the encode's emission plan
and stream assembly (which also gives the group index a sidecar is built
from), the +Huf table's byte histogram, and the decode's copy of its
values into the array it returns, on threads. At first use
the source is compiled with g++ into ``build/sprintz_tpu_torch/`` at the
root of the checkout (``ops/_build.BUILD_DIR``), under a name keyed by the
source, the flags and the compiler's target (``-march=native``), so an
edited source or another host's CPU gets its own library. A missing g++ or
a failed build raises ``RuntimeError``; nothing falls back to the Python
versions, which stay beside their callers as the plain versions the tests
hold this library to.

Each wrapper counts its calls into the library in its ``calls`` attribute,
as the kernel wrappers count their launches, and the threads the library
started for them in ``threads``; ``threads_started`` reads the library's
own count of them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

from .constants import BLOCK_SZ, METADATA_LEN_RLE
from .errors import CorruptStreamError
from .ops import _build

SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "sprintz_host.cpp"
GXX_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-shared", "-pthread",
             "-march=native")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
SIGNATURES = {
    "sprintz_walk_headers": (_P, _L, _L, _L, _I, _I, _I, _I, _L, _P, _P, _P,
                             _P, _P),
    "sprintz_walk_headers_parallel": (_P, _L, _P, _P, _L, _L, _L, _I, _I, _I,
                                      _L, _P, _P, _P, _P, _P),
    "sprintz_gather_blocks": (_P, _L, _P, _P, _L, _L, _P, _L),
    "sprintz_gather_dims": (_P, _L, _P, _P, _L, _I, _L, _P, _L),
    "sprintz_build_plan": (_P, _L, _I, _I, _P, _P, _P),
    "sprintz_assemble_stream": (_P, _P, _L, _L, _L, _P, _P, _P, _L, _I, _I,
                                _I, _P, _L, _P, _L, _P, _P, _P, _L),
    "sprintz_histogram": (_P, _L, _P),
    "sprintz_copy": (_P, _P, _L, _I),
    "sprintz_threads_started": (),
}


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the host runtime of "
                           "sprintz_tpu_torch (csrc/sprintz_host.cpp) "
                           "cannot be built")
    return gxx


def _target(gxx: str) -> pathlib.Path:
    """The library's path: a hash of the source, the flags and the macros
    g++ defines for them here (its version and the host's ISA)."""
    macros = subprocess.run(
        [gxx, *GXX_FLAGS, "-dM", "-E", "-x", "c++", "-"], input=b"",
        capture_output=True, timeout=120)
    if macros.returncode:
        raise RuntimeError(f"g++ failed (rc {macros.returncode}):\n"
                           + (macros.stdout + macros.stderr).decode())
    key = hashlib.sha256(b"\0".join(
        [" ".join(GXX_FLAGS).encode(), SRC.read_bytes(), macros.stdout]))
    return _build.BUILD_DIR / f"libsprintz_host_{key.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile ``csrc/sprintz_host.cpp`` unless its library exists; return
    the library's path. Concurrent processes (test workers) each write a
    file of their own and move it into place."""
    gxx = _gxx()
    lib = _target(gxx)
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        try:
            out = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                                 capture_output=True, timeout=600)
            if out.returncode:
                raise RuntimeError(
                    f"g++ failed:\n{SRC.name} (rc {out.returncode}): "
                    + (out.stdout + out.stderr).decode())
            os.replace(tmp, lib)
        finally:
            tmp.unlink(missing_ok=True)
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int64
    return lib


def _call(wrapper, *args) -> int:
    """The library's entry point of ``wrapper`` (``sprintz_<its name>``)
    on ``args``, counted in the wrapper's ``calls`` and ``threads``."""
    lib = _library()
    before = lib.sprintz_threads_started()
    wrapper.calls += 1
    out = getattr(lib, "sprintz_" + wrapper.__name__)(*args)
    wrapper.threads += lib.sprintz_threads_started() - before
    return out


def threads_started() -> int:
    """The threads the library has started since it was loaded: 0 before
    it is (reading it builds nothing)."""
    if not _library.cache_info().currsize:
        return 0
    return int(_library().sprintz_threads_started())


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _u8(buf) -> np.ndarray:
    """A bytes-like stream as a flat uint8 array, without a copy."""
    if isinstance(buf, np.ndarray):
        return np.ascontiguousarray(buf, dtype=np.uint8).reshape(-1)
    return np.frombuffer(buf, dtype=np.uint8)


def _walk_outputs(cap: int, ndims: int):
    return (np.empty((cap, ndims), dtype=np.uint8),
            np.empty(cap, dtype=np.int64), np.empty(cap, dtype=np.int64),
            np.empty(cap, dtype=np.int32), np.zeros(3, dtype=np.int64))


def walk_headers(buf, ngroups: int, ndims: int, elem_sz: int,
                 lowdim: bool, start: int = METADATA_LEN_RLE,
                 runs: bool = True):
    """The header walk over ``ngroups`` groups from byte ``start`` (the
    first group, right after the stream's metadata, unless a sidecar's
    checkpoint says otherwise) ->
    (widths (ndata, D) uint8, payload offsets (ndata,) int64, first rows
    (ndata,) int64, row bytes (ndata,) int32, total rows, tail offset).
    Raises ``CorruptStreamError`` when the walk would overrun the buffer.
    ``runs=False``: a non-RLE stream's walk (``simple.py``), where a block
    of all-zero widths is a data block of width 0, not a run.

    With runs every data block takes at least one payload byte, so a
    stream of n bytes holds fewer than n of them; without, every group
    takes at least a header byte, so it holds at most 2n. The outputs are
    sized by the smaller of that and the metadata's 2 * ngroups, which a
    corrupt stream may set to billions."""
    data = _u8(buf)
    cap = max(min(2 * int(ngroups), data.size * (1 if runs else 2)), 1)
    widths, offsets, out_rows, row_bytes, meta = _walk_outputs(cap, ndims)
    ndata = _call(
        walk_headers, _ptr(data), data.size, start, ngroups, ndims, elem_sz,
        int(lowdim), int(runs), cap, _ptr(widths), _ptr(offsets),
        _ptr(out_rows), _ptr(row_bytes), _ptr(meta))
    if ndata < 0:
        raise CorruptStreamError(
            f"stream walk overran the buffer (len {data.size}): truncated "
            f"stream or inconsistent metadata")
    return (widths[:ndata], offsets[:ndata], out_rows[:ndata],
            row_bytes[:ndata], int(meta[1]), int(meta[2]))


def walk_headers_parallel(buf, byte_offsets: np.ndarray,
                          row_offsets: np.ndarray, every_groups: int,
                          ngroups: int, ndims: int, elem_sz: int,
                          lowdim: bool):
    """``walk_headers`` over all ``ngroups`` groups, split at a sidecar's
    checkpoints: segment s walks ``every_groups`` groups from byte
    ``byte_offsets[s]``, its rows counted from ``row_offsets[s]``, the
    segments on threads. Same outputs as ``walk_headers``. Raises
    ``CorruptStreamError`` when a segment's walk would overrun the buffer
    or its rows do not end where the next segment's start."""
    data = _u8(buf)
    bo = np.ascontiguousarray(byte_offsets, dtype=np.int64)
    ro = np.ascontiguousarray(row_offsets, dtype=np.int64)
    if bo.size < 1 or bo.size != ro.size:
        raise CorruptStreamError("sidecar has no checkpoints, or unequal "
                                 "byte and row offsets")
    # each segment writes from 2 x its first group on: room for 2 blocks a
    # group, which a stream of that many groups has bytes for (a group
    # takes 3 at least)
    if 3 * int(ngroups) > data.size:
        raise CorruptStreamError(
            f"stream of {data.size} bytes cannot hold {ngroups} groups")
    cap = max(2 * int(ngroups), 1)
    widths, offsets, out_rows, row_bytes, meta = _walk_outputs(cap, ndims)
    ndata = _call(
        walk_headers_parallel, _ptr(data), data.size, _ptr(bo), _ptr(ro),
        bo.size, every_groups, ngroups, ndims, elem_sz, int(lowdim), cap,
        _ptr(widths), _ptr(offsets), _ptr(out_rows), _ptr(row_bytes),
        _ptr(meta))
    if ndata == -2:
        raise CorruptStreamError(
            "sidecar inconsistent with stream: segment row counts do not "
            "stitch to the recorded row offsets")
    if ndata < 0:
        raise CorruptStreamError(
            f"stream walk overran the buffer (len {data.size}) from a "
            f"checkpoint: truncated stream or a sidecar of another stream")
    return (widths[:ndata], offsets[:ndata], out_rows[:ndata],
            row_bytes[:ndata], int(meta[1]), int(meta[2]))


def _gather_out(out: np.ndarray | None, shape: tuple) -> np.ndarray:
    """A gather's output: a new array, or the caller's (a contiguous
    uint8 array of that shape, such as a slice of a batch's buffer)."""
    if out is None:
        return np.empty(shape, dtype=np.uint8)
    if (out.shape != shape or out.dtype != np.uint8
            or not out.flags.c_contiguous):
        raise ValueError(f"gather output {out.shape} {out.dtype} is not a "
                         f"contiguous uint8 array of shape {shape}")
    return out


def gather_blocks(buf, offsets: np.ndarray, row_bytes: np.ndarray,
                  maxb: int, out: np.ndarray | None = None) -> np.ndarray:
    """Row-major payload gather: block i's 8 rows of ``row_bytes[i]`` bytes
    at ``offsets[i]`` -> (ndata, 8, maxb) uint8, zero past each row, into
    ``out`` when given."""
    data = _u8(buf)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    row_bytes = np.ascontiguousarray(row_bytes, dtype=np.int32)
    out = _gather_out(out, (offsets.size, BLOCK_SZ, maxb))
    if _call(gather_blocks, _ptr(data), data.size, _ptr(offsets),
             _ptr(row_bytes), offsets.size, maxb, _ptr(out), out.size) < 0:
        raise CorruptStreamError("a block's payload lies outside the stream")
    return out


def gather_dims(buf, offsets: np.ndarray, widths: np.ndarray,
                section_bytes: int, out: np.ndarray | None = None
                ) -> np.ndarray:
    """Lowdim payload gather: block i's D sections of ``widths[i, d]`` bytes
    from ``offsets[i]`` on -> (ndata, D, section_bytes) uint8, zero past
    each section's w bytes, into ``out`` when given."""
    data = _u8(buf)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    widths = np.ascontiguousarray(widths, dtype=np.uint8)
    ndata, ndims = widths.shape
    out = _gather_out(out, (ndata, ndims, section_bytes))
    if _call(gather_dims, _ptr(data), data.size, _ptr(offsets),
             _ptr(widths), ndata, ndims, section_bytes, _ptr(out),
             out.size) < 0:
        raise CorruptStreamError("a block's payload lies outside the stream")
    return out


def build_plan(zero_flags: np.ndarray, n_elems: int, ndims: int,
               run_cmp_allows_equal: bool):
    """The emission plan -> (kinds int8, values int32, ngroups,
    consumed blocks, remaining elements)."""
    zf = np.ascontiguousarray(zero_flags, dtype=np.uint8).reshape(-1)
    cap = 2 * max(zf.size, 1) + 4
    kinds = np.empty(cap, dtype=np.int8)
    values = np.empty(cap, dtype=np.int32)
    meta = np.zeros(4, dtype=np.int64)
    nslots = _call(
        build_plan, _ptr(zf), n_elems, ndims, int(run_cmp_allows_equal),
        _ptr(kinds), _ptr(values), _ptr(meta))
    if not 0 <= nslots <= cap:
        raise RuntimeError(f"sprintz_build_plan returned {nslots} slots "
                           f"(capacity {cap})")
    return (kinds[:nslots], values[:nslots], int(meta[1]), int(meta[2]),
            int(meta[3]))


def assemble_stream(kinds: np.ndarray, values: np.ndarray, ngroups: int,
                    remaining_elems: int, widths: np.ndarray,
                    hdrvals: np.ndarray, dense: np.ndarray, ndims: int,
                    elem_sz: int, lowdim: bool, tail: np.ndarray,
                    wsums: np.ndarray | None = None,
                    group_index: bool = False, meta: bytes | None = None):
    """The final byte stream. ``widths`` and ``hdrvals`` are (nb, D)
    uint8, ``dense`` (nb, 8, maxb) or, ``lowdim``, (nb, D, maxb) uint8;
    ``wsums`` the (nb,) int32 width sums, which spare the library a pass
    over the widths. With ``group_index``, returns (stream, each group's
    byte offset, each group's first row), int64 arrays of the plan's
    groups. ``meta``: the bytes that open the stream in place of the RLE
    metadata (a non-RLE stream's header, or none), None for the RLE
    metadata. Raises ``RuntimeError`` when the library refuses: the buffer
    is sized for any plan, so that is a bug, not a bad input."""
    kinds = np.ascontiguousarray(kinds, dtype=np.int8)
    values = np.ascontiguousarray(values, dtype=np.int32)
    widths = np.ascontiguousarray(widths, dtype=np.uint8)
    hdrvals = np.ascontiguousarray(hdrvals, dtype=np.uint8)
    dense = np.ascontiguousarray(dense, dtype=np.uint8)
    tail = np.ascontiguousarray(tail).reshape(-1).view(np.uint8)
    if wsums is not None:
        wsums = np.ascontiguousarray(wsums, dtype=np.int32)
    # the metadata, a header of at most ndims + 1 bytes and at most 8 + 2
    # bytes of varints a slot, every payload (no larger than its dense
    # block), the tail
    # one byte more, so that an empty header still has an address
    head = (None if meta is None
            else np.frombuffer(bytes(meta) + b"\0", dtype=np.uint8))
    cap = ((8 if head is None else head.size) + dense.nbytes
           + kinds.size * (ndims + 11) + tail.size)
    out = np.empty(cap, dtype=np.uint8)
    ng = (kinds.size + 1) // 2  # the library's groups: two slots each
    gidx = np.empty((2, ng), dtype=np.int64) if group_index else None
    n = _call(
        assemble_stream, _ptr(kinds), _ptr(values), kinds.size, ngroups,
        remaining_elems, _ptr(widths), _ptr(hdrvals), _ptr(dense),
        dense.shape[-1], ndims, elem_sz, int(lowdim), _ptr(tail), tail.size,
        _ptr(out), cap,
        None if wsums is None else _ptr(wsums),
        None if gidx is None else _ptr(gidx),
        None if head is None else _ptr(head), 0 if head is None else len(meta))
    if n < 0:
        raise RuntimeError(f"sprintz_assemble_stream refused its buffer of "
                           f"{cap} bytes")
    if group_index:
        return out[:n].tobytes(), gidx[0], gidx[1]
    return out[:n].tobytes()


def histogram(data) -> np.ndarray:
    """Byte counts of ``data`` -> (256,) int64, as ``np.bincount(data,
    minlength=256)``."""
    data = _u8(data)
    counts = np.empty(256, dtype=np.int64)
    _call(histogram, _ptr(data), data.size, _ptr(counts))
    return counts


def copy(dst: np.ndarray, src: np.ndarray, threads: int = 64) -> None:
    """``dst[...] = src`` for two C-contiguous arrays of the same bytes,
    ``dst`` writable: on one thread for every 2 MiB at least, up to
    ``threads`` and the host's cores (the decode's join)."""
    if (dst.nbytes != src.nbytes or not dst.flags.c_contiguous
            or not src.flags.c_contiguous or not dst.flags.writeable):
        raise ValueError(f"copy of {src.nbytes} bytes into {dst.nbytes}: "
                         f"both must be C-contiguous, the target writable")
    _call(copy, _ptr(dst), _ptr(src), dst.nbytes, threads)


# the stream format's entry points; ``copy``, a plain copy, counts apart
ENTRY_POINTS = (walk_headers, walk_headers_parallel, gather_blocks,
                gather_dims, build_plan, assemble_stream, histogram)
for _fn in (*ENTRY_POINTS, copy):
    _fn.calls = 0
    _fn.threads = 0
