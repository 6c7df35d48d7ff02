#!/usr/bin/env python3
"""Build the delta decode's kernels (``csrc/decode.cu``: K1/K4/K5
``unpack_zz_kernel``, K2 ``prefix_finish_kernel`` and the lowdim decode
``decode_lowdim_kernel``, serial, in chunks and with the query's reduce as
their epilogue), the encode kernels
(``csrc/pack.cu``: K3 ``pack_rows_kernel`` and the lowdim
``encode_lowdim_kernel``) and the FIRE kernels (``csrc/fire.cu``: the
encode with and without its states, the decode serial, in long chunks on
the ring kernel and in short ones on ``fire_decode_short_kernel``) on the
host with g++, and the query pushdown's reduce (``csrc/query.cu``:
``reduce_cols_kernel``), and hold them to their plain versions at the cases
of ``probes/unpack_cases.py`` (``UNPACK_CASES``, ``LOWDIM_CASES``,
``SEED_CASES``, ``CHUNK_CASES``), ``probes/encode_cases.py``
(``PACK_CASES``, ``LOWDIM_PACK_CASES``) and ``FIRE_CASES``,
``QUERY_CASES`` and ``EPILOGUE_CASES`` below, with no card and no nvcc.

    python3 sprintz_tpu_torch/probes/host_build.py [--resident 1 3] [--src FILE]

A source is compiled as C++ against ``host_shim.h``: its launches
become calls that run each CUDA thread as a std::thread, ``resident``
CTAs at a time (more than one, so that a look-back waits on tiles or
spans that run beside it); its device helpers (``cp.async``, the status
words; FIRE's mbarriers) are replaced between their marker lines by
copies that land when a wait covers their group, and C++ atomics (an
mbarrier is a word of pending arrivals, phase and expected count). Shared memory and every output
start as garbage, so a byte the kernel fails to write, or reads before
its copy lands, shows; the lowdim decode's status words start zeroed, as
the wrapper keeps them, and must be zeroed again after each launch, as
must the reduce's kept accumulators and their count. The shim's card has
2 SMs of 2 CTAs, so the reduce's one-wave grid strides over rows. The C
entry points are called through ctypes as the wrappers call them. It
prints one line a case and exits 1 on the first difference. Not imported
by the port.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import pathlib
import re
import subprocess
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
SRC = ROOT / "sprintz_tpu_torch" / "csrc" / "decode.cu"
PACK_SRC = ROOT / "sprintz_tpu_torch" / "csrc" / "pack.cu"
FIRE_SRC = ROOT / "sprintz_tpu_torch" / "csrc" / "fire.cu"
QUERY_SRC = ROOT / "sprintz_tpu_torch" / "csrc" / "query.cu"
OUT = ROOT / "build" / "sprintz_tpu_torch" / "host"
HELPERS = re.compile(r"// ---- device helpers \(PTX\)\n.*?// ---- end of device helpers\n",
                     re.S)
HOST_HELPERS = """
// cp.async: a copy lands only when a wait covers its group, so that a read
// of shared memory before its wait sees the garbage the shim put there
inline thread_local std::vector<std::pair<void*, const void*>> g_open;
inline thread_local std::vector<std::vector<std::pair<void*, const void*>>> g_groups;
inline void cp_async16(void* dst, const void* src) { g_open.push_back({dst, src}); }
inline void cp_async_commit() {
  g_groups.push_back(std::move(g_open));
  g_open.clear();
}
inline void shim_land(size_t pending) {
  while (g_groups.size() > pending) {
    for (auto& [dst, src] : g_groups.front()) std::memcpy(dst, src, 16);
    g_groups.erase(g_groups.begin());
  }
}
inline void cp_async_wait_prior() { shim_land(1); }
inline void cp_async_wait_all() {
  cp_async_commit();
  shim_land(0);
}
inline unsigned long long ld_status(const unsigned long long* p) {
  std::this_thread::yield();
  return std::atomic_ref<unsigned long long>(*const_cast<unsigned long long*>(p)).load();
}
inline void st_status(unsigned long long* p, unsigned long long v) {
  std::atomic_ref<unsigned long long>(*p).store(v);
}
"""
FIRE_HELPERS = re.compile(r"// ---- mbarriers and timers \(PTX\)\n.*?// ---- end of PTX\n",
                          re.S)
FIRE_HOST_HELPERS = """
// an mbarrier: its pending arrivals (bits 0-30), its phase (bit 31) and the
// arrivals a phase expects (bits 32-63); the last arrival of a phase flips
// it and restores the count. A wait for a parity returns once the phase
// differs from it (the phase of that parity has completed).
inline std::atomic_ref<uint64_t> shim_bar(uint64_t* bar) { return std::atomic_ref<uint64_t>(*bar); }
inline void mbar_init(uint64_t* bar, uint32_t arrivals) {
  shim_bar(bar).store(((uint64_t)arrivals << 32) | arrivals);
}
inline void mbar_init_fence() {}
inline void mbar_arrive(uint64_t* bar) {
  auto a = shim_bar(bar);
  uint64_t old = a.load(), next;
  do {
    const uint64_t pending = old & 0x7fffffffu, expected = old >> 32;
    next = pending == 1 ? (expected << 32) | (~old & 0x80000000u) | expected : old - 1;
  } while (!a.compare_exchange_weak(old, next));
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (((shim_bar(bar).load() >> 31) & 1u) == parity) std::this_thread::yield();
}
inline unsigned long long global_ns() { return 0; }
// c + a's signed 16-bit halves times b's bytes 0 and 1, unsigned
inline uint32_t dp2a_su(int32_t a, uint32_t b, uint32_t c) {
  const uint32_t p0 = (uint32_t)(int32_t)(int16_t)(a & 0xffff) * (b & 0xffu);
  const uint32_t p1 = (uint32_t)(int32_t)(int16_t)((uint32_t)a >> 16) * ((b >> 8) & 0xffu);
  return c + p0 + p1;
}
"""
ENTRY = """
extern "C" void sprintz_shim_set_resident(int n) { g_resident = n; }
extern "C" int sprintz_shim_fault() { return g_fault.exchange(0); }
"""


# the C entry points' argtypes, as ops/_build.py binds them
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ENTRIES = {
    "sprintz_unpack_zz": [P, P, P, P, P, L, I, I, I, I, P, I, P, P],
    "sprintz_prefix_finish": [P, P, P, L, I, I, P, I, P, P],
    "sprintz_decode_lowdim": [P, P, P, P, L, I, I, I, P, I, P, P],
    "sprintz_pack_rows": [P, P, P, L, I, I, I, P],
    "sprintz_encode_lowdim": [P, P, P, P, P, L, I, I, I, P],
    "sprintz_fire_scan": [P, P, P, P, P, L, I, I, I, I, P],
    "sprintz_fire_decode_chunks": [P, P, P, I, P, L, I, I, I, P],
    "sprintz_fire_decode_short": [P, P, P, I, L, P, L, I, I, I, P],
    "sprintz_prefix_finish_reduce": [P, P, P, L, I, I, I, P, I, I, P, P, P],
    "sprintz_decode_lowdim_reduce": [P, P, P, P, L, I, I, I, P, I, I, P, P, P],
    "sprintz_reduce_cols": [P, P, P, L, I, I, I, I, P, P],
}
# (elem_bits, ndims, blocks, chunks, truncated coefficient): FIRE's chunked
# decode at chunk counts 1, 2, 7 and 33 of unequal lengths (empty ones
# too), a CTA of 32 / D chunks at D <= 4 (3: two lanes shadow), chunks
# that span CTAs of dims at D 33 and 64, and rings that wrap (more than 8
# tiles of 16 blocks in a chunk). Each case runs both chunked kernels where
# its chunks fit the short one (the ring's on the same chunks), and the
# ring's alone where they do not (u16 D 64 nb 150, u8 D 64 nb 150 at 3
# chunks of up to 150 blocks)
FIRE_CASES = [(8, 4, 40, 7, False), (8, 3, 33, 33, False), (16, 2, 300, 2, False),
              (8, 1, 17, 1, False), (16, 1, 60, 33, False), (8, 33, 40, 7, True),
              (16, 31, 35, 2, True), (8, 64, 150, 3, True), (16, 5, 9, 1, True)]
# (elem_bits, ndims, blocks, wraps): the preprocessor's FIRE (the transform
# instantiations of the serial encode and decode): odd D (at u8 the even
# and odd dims' CTAs of the decode, one with no dim of its parity at D 1
# and 65), D 64 and 65 (a second CTA pair, a lone even dim), rings that
# wrap (more than 8 tiles of 16 blocks), and with ``wraps`` a u8 stream
# whose learning counter passes 32767 and wraps
FIRE_TRANSFORM_CASES = [(8, 1, 40, False), (8, 5, 150, False), (8, 65, 20, False),
                        (16, 3, 150, False), (16, 33, 17, False), (8, 2, 1100, True)]
# FIRE's chunked decode at explicit chunk shapes: (elem_bits, ndims, blocks,
# chunks: a count of chunk_cuts' or the chunk starts, truncated
# coefficient). u8 D 1: 64 chunks a CTA of the short kernel, ragged and some
# empty; D 3: 21 chunks a CTA whose images start 8 bytes into a unit, more
# chunks than blocks; u16 D 2: 32 a CTA; D 33: 64 threads, 31 idle; D 256:
# the widest CTA; u16 D 64 at a sidecar's 32-block chunks (32 KB a chunk);
# u16 D 7; u8 D 64 past the short kernel's budget (the ring kernel's alone)
SHORT_CASES = [(8, 1, 300, 150, False), (8, 3, 50, 70, False),
               (16, 2, 200, 40, False), (8, 33, 48, 5, True),
               (8, 256, 6, 3, True), (16, 64, 96, [0, 32, 64, 96], True),
               (16, 7, 64, 9, True), (8, 64, 120, [0, 100, 120], True)]
# (elem_bits, ndims, rows): the reduce's three loads. 16-byte vectors of
# whole rows (a row's bytes divide 16: u8 D 1, 2, 4, 8, u16 D 1, 2, 4; a
# short last vector where the bytes do not fill it, two blocks' last rows
# in a vector at u8 D 1), 16-byte vectors of a row (its bytes a multiple of
# 16: u8 D 16 and 64, u16 D 64; 3 vectors a row at u8 D 48 and u16 D 24,
# 64 in two column tiles at u8 D 1024), a value at a time (D 3, 5, 33, 129:
# ragged column tiles of 4, 8 and 32 lanes); one row, rows that end inside
# a block, and u16 sums that wrap past 2^31 (40000 rows near 65535)
QUERY_CASES = [(8, 1, 1), (8, 1, 1048), (8, 2, 4104), (8, 3, 2049), (8, 4, 4096),
               (8, 5, 808), (8, 8, 1000), (8, 16, 808), (8, 48, 520), (8, 64, 1000),
               (8, 129, 264), (8, 1024, 64), (16, 1, 40000), (16, 2, 520), (16, 4, 1000),
               (16, 24, 72), (16, 33, 3000), (16, 64, 2048)]
# (elem_bits, ndims, blocks, values): the reduce as the epilogue of K2 (every
# row-major width, and lowdim widths up to 100 blocks) and of the lowdim
# decode (u8 D <= 4, u16 D <= 2), values of a walk
# or near the top of the range, each op with and without store, the sum
# with gaps (some near 2^31 rows: u16 sums wrap) and min after a leading
# run. K2: a short last tile (nb 100), one whole tile (nb 32, D 5: neither
# a divisor nor a multiple of 16), one short tile (nb 7, D 33), rows past
# a tile's shared memory (D 600: dims in chunks); the lowdim decode: spans
# of 1024 blocks and a short second one (u8 D 1), K = 1 (u8 D 3), u16
CASE_GAPS_TOP = (1 << 31) - 1
EPILOGUE_CASES = [(8, 64, 100, "walk"), (8, 5, 32, "walk"), (8, 33, 7, "top"),
                  (16, 3, 70, "walk"), (16, 64, 40, "top"), (8, 600, 40, "walk"),
                  (8, 4, 300, "walk"), (8, 1, 1100, "top"), (8, 3, 257, "walk"),
                  (16, 2, 400, "top"), (16, 1, 40, "walk")]


def host_source(src: str, kernels: int, helpers: re.Pattern | None = HELPERS,
                host_helpers: str = HOST_HELPERS) -> str:
    """A kernel source as C++ for the shim: its device helpers, its shared
    memory, its ``kernels`` launches."""
    out = src
    if helpers is not None:
        out, n = helpers.subn(host_helpers, src)
        assert n == 1, "the device helpers' marker lines"
    out = out.replace("#include <cuda_runtime.h>\n", "")
    out, n = re.subn(r"extern __shared__ __align__\(16\) (uint8_t|unsigned char) (\w+)\[\];",
                     r"\1* \2 = shim_smem();", out)
    out, m = re.subn(r"extern __shared__ uint4 smem\[\];",
                     "uint4* smem = reinterpret_cast<uint4*>(shim_smem());", out)
    assert n + m <= kernels, "a dynamic shared buffer a kernel at most"
    out, n = re.subn(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\(", r"shim_launch(\1, \2, ", out,
                     flags=re.S)
    assert n == kernels, "one launch a kernel"
    return out + ENTRY


def build(src: pathlib.Path = SRC, out: pathlib.Path = OUT, kernels: int = 3,
          helpers: re.Pattern | None = HELPERS,
          host_helpers: str = HOST_HELPERS) -> ctypes.CDLL:
    """Compile ``src`` for the shim into ``out`` (reused while the source
    and the shim are unchanged) and load it."""
    text = host_source(src.read_text(), kernels, helpers, host_helpers)
    key = hashlib.sha256(text.encode() + (HERE / "host_shim.h").read_bytes()).hexdigest()[:16]
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{src.stem}_host_{key}.so"
    if not lib.exists():
        cpp = out / f"{src.stem}_host_{key}.cpp"
        cpp.write_text(text)
        subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
                        "-include", str(HERE / "host_shim.h"), "-o", str(lib), str(cpp)],
                       check=True)
    so = ctypes.CDLL(str(lib))
    for name, argtypes in ENTRIES.items():
        if hasattr(so, name):
            getattr(so, name).argtypes = argtypes
    so.sprintz_shim_set_resident.argtypes = [I]
    return so


def build_pack(src: pathlib.Path = PACK_SRC, out: pathlib.Path = OUT) -> ctypes.CDLL:
    """``build`` for pack.cu: two kernels."""
    return build(src, out, kernels=2)


def build_fire(src: pathlib.Path = FIRE_SRC, out: pathlib.Path = OUT) -> ctypes.CDLL:
    """``build`` for fire.cu: the encode, the two decodes and the chain
    probe, with its mbarriers."""
    return build(src, out, kernels=4, helpers=FIRE_HELPERS, host_helpers=FIRE_HOST_HELPERS)


def build_query(src: pathlib.Path = QUERY_SRC, out: pathlib.Path = OUT) -> ctypes.CDLL:
    """``build`` for query.cu: the reduce, which has no device helpers."""
    return build(src, out, kernels=1, helpers=None)


class HostKernels:
    """The wrappers' calls of the C entry points, on CPU tensors (the
    query's on ``device``'s: ``probes/query_probe.py`` makes the same calls
    on the card)."""

    device = "cpu"

    def __init__(self, so: ctypes.CDLL, resident: int):
        import torch

        self.so, self.torch = so, torch
        so.sprintz_shim_set_resident(resident)
        self.gen = torch.Generator().manual_seed(resident)

    def garbage(self, shape, dtype):
        t = self.torch
        raw = t.randint(0, 256, (int(np.prod(shape)) * t.empty((), dtype=dtype).element_size(),),
                        dtype=t.uint8, generator=self.gen)
        return raw.view(dtype).reshape(shape)

    def check(self, err: int):
        if err or self.so.sprintz_shim_fault():
            raise RuntimeError(f"host kernel: error {err} or a shared-memory overrun")

    def chunk_ptrs(self, chunks):
        """(first, nchunks, states) pointers of ``chunks`` = (first (C + 1,)
        int64, states (C, D) int32), or nulls; the tensors are kept on self
        while the call runs."""
        if chunks is None:
            return None, 0, None
        t = self.torch
        self._keep = (t.from_numpy(np.asarray(chunks[0], dtype=np.int64).copy()),
                      t.as_tensor(chunks[1], dtype=t.int32).contiguous())
        return self._keep[0].data_ptr(), self._keep[0].numel() - 1, self._keep[1].data_ptr()

    def unpack(self, dense, widths, elem_bits: int, raw: int, chunks=None):
        from sprintz_tpu_torch.ops import decode_kernels as dk

        t = self.torch
        nb, _, maxb = dense.shape
        nd = widths.shape[1]
        ntiles = -(-nb // dk.TILE_BLOCKS)
        if raw:
            odt = t.uint8 if elem_bits == 8 else t.int32
        else:
            odt = dk.narrow_dtype(elem_bits)
        out = self.garbage((nb, 8, nd), odt)
        toff = self.garbage((ntiles, 1, nd), t.int32)
        status = self.garbage((ntiles * nd + 1,), t.int64)
        dense, widths = dk.aligned16(dense), dk.aligned16(widths)
        self.check(self.so.sprintz_unpack_zz(
            dense.data_ptr(), widths.data_ptr(), out.data_ptr(),
            None if raw else toff.data_ptr(), None if raw else status.data_ptr(),
            nb, nd, maxb, elem_bits, raw, *self.chunk_ptrs(chunks), None))
        return out if raw else (out, toff)

    def decode_lowdim(self, dense, widths, elem_bits: int, raw: int, chunks=None):
        """The lowdim decode's values (raw: its fields), from a zeroed
        status buffer that the launch must leave zeroed."""
        from sprintz_tpu_torch.ops import decode_kernels as dk

        t = self.torch
        nb, nd, _ = dense.shape
        if raw:
            out = self.garbage((nb, 8, nd), t.uint8 if elem_bits == 8 else t.int32)
        else:
            out = self.garbage((nb * 8, nd), dk.narrow_dtype(elem_bits))
        status = t.zeros(-(-nb // dk.lowdim_span_blocks(elem_bits, nd)) + 1,
                         dtype=t.int64)
        dense, widths = dk.aligned16(dense), dk.aligned16(widths)
        self.check(self.so.sprintz_decode_lowdim(
            dense.data_ptr(), widths.data_ptr(), out.data_ptr(),
            None if raw else status.data_ptr(), nb, nd, elem_bits, raw,
            *self.chunk_ptrs(chunks), None))
        if status.any():
            raise RuntimeError("host kernel: the lowdim decode left its status words set")
        return out

    def pack_rows(self, errs, widths, elem_sz: int):
        from sprintz_tpu_torch.ops import pack_kernels as pk

        nb, _, nd = errs.shape
        out = self.garbage((nb, 8, nd * elem_sz), self.torch.uint8)
        self.check(self.so.sprintz_pack_rows(
            errs.data_ptr(), widths.data_ptr(), out.data_ptr(), nb, nd, elem_sz,
            pk.pack_tile_rows(nd, elem_sz), None))
        return out

    def encode_lowdim(self, x, elem_sz: int, errors: bool):
        from sprintz_tpu_torch.ops import decode_kernels as dk

        t = self.torch
        nb, nd = x.shape[0] // 8, x.shape[1]
        widths = self.garbage((nb, nd), t.uint8)
        hdr = self.garbage((nb, nd), t.uint8)
        dense = self.garbage((nb, nd, 8 * elem_sz), t.uint8)
        wsums = self.garbage((nb,), t.int32)
        x = dk.aligned16(x)
        self.check(self.so.sprintz_encode_lowdim(
            x.data_ptr(), widths.data_ptr(), hdr.data_ptr(), dense.data_ptr(),
            wsums.data_ptr(), nb, nd, elem_sz, 0 if errors else 1, None))
        return widths, hdr, dense, wsums

    def fire_encode(self, rows, elem_bits: int, trunc: bool, states: bool,
                    init=None, final: bool = False):
        """The serial encode (sprintz_fire_scan), from ``init`` or zeros;
        with ``final`` also the carry after it (into garbage)."""
        t = self.torch
        n, nd = rows.shape
        out = self.garbage((n, nd), t.int32)
        words = self.garbage((n // 8, nd, 4), t.int32) if states else None
        ini = None if init is None else init.to(t.int32).contiguous()
        fin = self.garbage((3, nd), t.int32) if final else None
        self.check(self.so.sprintz_fire_scan(
            rows.data_ptr(), None if ini is None else ini.data_ptr(),
            None if fin is None else fin.data_ptr(),
            None if words is None else words.data_ptr(),
            out.data_ptr(), n // 8, nd, elem_bits, 0, int(trunc), None))
        res = (out, words[..., :3].transpose(1, 2)) if states else (out,)
        res += (fin,) if final else ()
        return res if len(res) > 1 else out

    def fire_decode(self, errs, elem_bits: int, state, trunc: bool,
                    final: bool = False):
        """The serial decode (sprintz_fire_scan), from ``state`` or zeros;
        with ``final`` also the carry after it (into garbage)."""
        from sprintz_tpu_torch.ops import decode_kernels as dk

        t = self.torch
        n, nd = errs.shape
        out = self.garbage((n, nd), dk.narrow_dtype(elem_bits))
        st = None if state is None else state.to(t.int32).contiguous()
        fin = self.garbage((3, nd), t.int32) if final else None
        self.check(self.so.sprintz_fire_scan(
            errs.data_ptr(), None if st is None else st.data_ptr(),
            None if fin is None else fin.data_ptr(), None, out.data_ptr(),
            n // 8, nd, elem_bits, 1, int(trunc), None))
        return (out, fin) if final else out

    def fire_transform(self, x, elem_bits: int, decode: bool):
        """The preprocessor's FIRE (sprintz_fire_scan's transform mode): x
        the values (i32) to encode, or the raw errors (uint8, or int16 at
        u16) to decode, into garbage."""
        from sprintz_tpu_torch.models import forecasters as fc
        from sprintz_tpu_torch.ops import decode_kernels as dk

        t = self.torch
        n, nd = x.shape
        out = self.garbage((n, nd), dk.narrow_dtype(elem_bits) if decode else t.int32)
        self.check(self.so.sprintz_fire_scan(
            x.data_ptr(), None, None, None, out.data_ptr(), n // 8, nd, elem_bits,
            int(decode), fc.MODE_TRANSFORM, None))
        return out

    def fire_decode_chunks(self, errs, elem_bits: int, first, states, trunc: bool,
                           short: bool):
        """The chunked decode on the short-chunk kernel (``short``) or the
        ring kernel."""
        from sprintz_tpu_torch.ops import decode_kernels as dk

        t = self.torch
        n, nd = errs.shape
        out = self.garbage((n, nd), dk.narrow_dtype(elem_bits))
        f = t.from_numpy(np.asarray(first, dtype=np.int64).copy())
        st = states.to(t.int32).contiguous()
        errs = dk.aligned16(errs)
        if short:
            err = self.so.sprintz_fire_decode_short(
                errs.data_ptr(), st.data_ptr(), f.data_ptr(), f.numel() - 1,
                int(np.diff(f.numpy()).max()), out.data_ptr(), n // 8, nd, elem_bits,
                int(trunc), None)
        else:
            err = self.so.sprintz_fire_decode_chunks(
                errs.data_ptr(), st.data_ptr(), f.data_ptr(), f.numel() - 1, out.data_ptr(),
                n // 8, nd, elem_bits, int(trunc), None)
        self.check(err)
        return out

    def reduce_args(self, nd: int, gap_after):
        """An output of garbage, zeroed kept accumulators (D words and a
        count) and the gaps, 16-byte aligned, for a reduce launch."""
        from sprintz_tpu_torch.ops import decode_kernels as dk

        t = self.torch
        gaps = None if gap_after is None else dk.aligned16(t.from_numpy(
            np.ascontiguousarray(gap_after, dtype=np.int32)).to(self.device))
        return (self.garbage((nd,), t.int32),
                t.zeros(nd + 1, dtype=t.int32, device=self.device), gaps)

    def check_cleared(self, acc):
        if acc.any():
            raise RuntimeError("host kernel: the reduce left its accumulators set")

    def reduce_cols(self, vals, op: str, gap_after, leading_gap: bool):
        """The reduce into an output of garbage, from zeroed accumulators
        that the launch must leave zeroed."""
        from sprintz_tpu_torch.ops import decode_kernels as dk
        from sprintz_tpu_torch.ops import query_kernels as qk

        rows, nd = vals.shape
        out, acc, gaps = self.reduce_args(nd, gap_after)
        vals = dk.aligned16(vals)
        self.check(self.so.sprintz_reduce_cols(
            vals.data_ptr(), None if gaps is None else gaps.data_ptr(), out.data_ptr(),
            rows, nd, 8 * vals.element_size(), qk.OPS.index(op), int(leading_gap),
            acc.data_ptr(), None))
        self.check_cleared(acc)
        return out

    def prefix_finish_reduce(self, bz, toff, elem_bits: int, op: str, gap_after,
                             leading_gap: bool, store: bool):
        """K2 with the reduce epilogue: (values into garbage, or None
        without store, the result)."""
        from sprintz_tpu_torch.ops import decode_kernels as dk
        from sprintz_tpu_torch.ops import query_kernels as qk

        rows, nd = bz.shape
        vals = self.garbage(tuple(bz.shape), bz.dtype) if store else None
        red, acc, gaps = self.reduce_args(nd, gap_after)
        bz, toff = dk.aligned16(bz), dk.aligned16(toff)
        self.check(self.so.sprintz_prefix_finish_reduce(
            bz.data_ptr(), toff.data_ptr(), None if vals is None else vals.data_ptr(), rows,
            nd, elem_bits, qk.OPS.index(op), None if gaps is None else gaps.data_ptr(),
            int(leading_gap), int(store), acc.data_ptr(), red.data_ptr(), None))
        self.check_cleared(acc)
        return vals, red

    def decode_lowdim_reduce(self, dense, widths, elem_bits: int, op: str, gap_after,
                             leading_gap: bool, store: bool):
        """The lowdim decode with the reduce epilogue, from zeroed status
        words and accumulators that the launch must leave zeroed."""
        from sprintz_tpu_torch.ops import decode_kernels as dk
        from sprintz_tpu_torch.ops import query_kernels as qk

        t = self.torch
        nb, nd, _ = dense.shape
        vals = self.garbage((nb * 8, nd), dk.narrow_dtype(elem_bits)) if store else None
        red, acc, gaps = self.reduce_args(nd, gap_after)
        status = t.zeros(-(-nb // dk.lowdim_span_blocks(elem_bits, nd)) + 1, dtype=t.int64,
                         device=self.device)
        dense, widths = dk.aligned16(dense), dk.aligned16(widths)
        self.check(self.so.sprintz_decode_lowdim_reduce(
            dense.data_ptr(), widths.data_ptr(), None if vals is None else vals.data_ptr(),
            status.data_ptr(), nb, nd, elem_bits, qk.OPS.index(op),
            None if gaps is None else gaps.data_ptr(), int(leading_gap), int(store),
            acc.data_ptr(), red.data_ptr(), None))
        self.check_cleared(acc)
        if status.any():
            raise RuntimeError("host kernel: the lowdim decode left its status words set")
        return vals, red

    def prefix_finish(self, bz, toff, elem_bits: int, chunks=None):
        from sprintz_tpu_torch.ops import decode_kernels as dk

        out = self.garbage(tuple(bz.shape), bz.dtype)
        bz, toff = dk.aligned16(bz), dk.aligned16(toff)
        self.check(self.so.sprintz_prefix_finish(
            bz.data_ptr(), toff.data_ptr(), out.data_ptr(), bz.shape[0], bz.shape[1],
            elem_bits, *self.chunk_ptrs(chunks), None))
        return out


def check_case(hk: HostKernels, eb: int, nd: int, nb: int, kind: str) -> str | None:
    """The host-built K1, K4, K5 (u8) and K2 against their plain versions
    at an ``unpack_cases`` case: the name of the first that differs, or
    None."""
    import torch

    from sprintz_tpu_torch.ops import decode_kernels as dk
    from sprintz_tpu_torch.ops import pack_kernels as pk
    from sprintz_tpu_torch.probes import unpack_cases as uc

    rng = np.random.default_rng(eb * 7919 + nd * 31 + nb)
    dense, widths, _ = uc.unpack_case(rng, eb, nd, nb, kind)
    d, w = uc.to_device(dense, widths, kind, "cpu")
    bz, toff = dk.unpack_zz_plain(d, w, eb)
    got_bz, got_toff = hk.unpack(d, w, eb, 0)
    bz2 = bz.reshape(-1, nd)
    pairs = [("K1 deltas", got_bz, bz), ("K1 tile offsets", got_toff, toff),
             ("K4", hk.unpack(d, w, 16, 1), pk.unpack_rows_plain(d, w)),
             ("K2", hk.prefix_finish(bz2, toff, eb), dk.prefix_finish_plain(bz2, toff, eb))]
    if eb == 8:
        pairs.append(("K5", hk.unpack(d, w, 8, 1), pk.unpack_rows_plain(d, w, True)))
    for name, got, want in pairs:
        if got.dtype != want.dtype or not torch.equal(got, want):
            return name
    return None


def check_lowdim_case(hk: HostKernels, eb: int, nd: int, nb: int,
                      kind: str) -> str | None:
    """The host-built lowdim decode (values; raw fields) against its plain
    versions at a ``LOWDIM_CASES`` case: the name of the first that
    differs, or None."""
    import torch

    from sprintz_tpu_torch.ops import decode_kernels as dk
    from sprintz_tpu_torch.probes import unpack_cases as uc

    rng = np.random.default_rng(eb * 7919 + nd * 31 + nb + 1)
    dense, widths, _ = uc.lowdim_case(rng, eb, nd, nb, kind)
    d, w = uc.to_device(dense, widths, kind, "cpu")
    pairs = [("lowdim decode", hk.decode_lowdim(d, w, eb, 0),
              dk.decode_delta_lowdim_plain(d, w, eb)),
             ("lowdim raw fields", hk.decode_lowdim(d, w, eb, 1),
              dk.unpack_dims_lowdim_plain(d, w))]
    for name, got, want in pairs:
        if got.dtype != want.dtype or not torch.equal(got, want):
            return name
    return None


def chunk_cuts(rng, nb: int, nchunks: int) -> np.ndarray:
    """C + 1 block indices from 0 to nb: chunks of unequal lengths, empty
    ones where C exceeds the blocks."""
    inner = np.sort(rng.integers(0, nb + 1, nchunks - 1))
    return np.concatenate([[0], inner, [nb]]).astype(np.int64)


def check_fire_case(hk: HostKernels, eb: int, nd: int, nb: int, nchunks: int,
                    trunc: bool) -> str | None:
    """The host-built FIRE kernels at a ``FIRE_CASES`` case: the encode with
    and without its states, the serial decode from a carried state and the
    chunked decode from the encode's states (one chunk's replaced by
    random ones, its delta wider than an element) against their plain
    versions, and the serial scans' carries (``check_fire_carries``): the
    name of the first that differs, or None."""
    import torch

    from sprintz_tpu_torch.models import forecasters as fc

    rng = np.random.default_rng(eb * 7919 + nd * 31 + nb * 3 + nchunks)
    half = 1 << (eb - 1)
    vals = (np.cumsum(rng.integers(-6, 7, (nb * 8, nd)), axis=0) % (2 * half))
    vals[: nb * 4] = rng.integers(0, 2 * half, (nb * 4, nd))
    rows = torch.from_numpy(vals.astype(np.int32))
    errs, carries = fc.fire_encode_plain(rows, eb, trunc, states=True)
    zz = errs.to(torch.uint8) if eb == 8 else errs
    first = chunk_cuts(rng, nb, nchunks)
    states = carries[torch.from_numpy(np.minimum(first[:-1], nb - 1))].clone()
    states[first[:-1] == nb] = 0
    k = int(rng.integers(0, nchunks))
    states[k] = torch.from_numpy(np.stack([
        rng.integers(0, 2 * half, nd), rng.integers(-(1 << 20), 1 << 20, nd),
        rng.integers(-(1 << 15), 1 << 15, nd)]).astype(np.int32))
    got_e, got_c = hk.fire_encode(rows, eb, trunc, True)
    chunked = fc.fire_decode_chunks_plain(zz, eb, first, states, trunc)
    pairs = [("FIRE encode", hk.fire_encode(rows, eb, trunc, False), errs),
             ("FIRE encode with states: errors", got_e, errs),
             ("FIRE encode with states: carries", got_c, carries),
             ("FIRE serial decode", hk.fire_decode(zz, eb, states[k], trunc),
              fc.fire_decode_plain(zz, eb, states[k], trunc)),
             ("FIRE chunked decode, ring kernel",
              hk.fire_decode_chunks(zz, eb, first, states, trunc, False), chunked)]
    if fc.fire_short_fits(int(np.diff(first).max()), nd, eb):
        pairs.append(("FIRE chunked decode, short kernel",
                      hk.fire_decode_chunks(zz, eb, first, states, trunc, True), chunked))
    for name, got, want in pairs:
        if got.dtype != want.dtype or not torch.equal(got, want):
            return name
    return check_fire_carries(hk, eb, nd, nb, trunc, rows, zz, states[k])


def wrapping_transform_rows(eb: int, nd: int, nb: int) -> np.ndarray:
    """(nb * 8, D) values on which the preprocessor's FIRE at u8 drives
    its learning counter up about 31 a block, past 32767 (so that it wraps)
    within 1100 blocks: the even rows' deltas are 31 and the odd rows'
    errors +1, so that every gradient term is +31. The values are made by
    running the scan's own recurrence forward, row by row."""
    assert eb == 8
    vals = np.zeros((nb * 8, nd), np.int64)
    prev_val = np.zeros(nd, np.int64)
    prev_delta = np.zeros(nd, np.int64)
    counter = np.zeros(nd, np.int64)
    even = np.arange(nd) % 2 == 0

    def sext(v, bits):
        return ((v + (1 << (bits - 1))) & ((1 << bits) - 1)) - (1 << (bits - 1))

    for b in range(nb):
        coef = sext((counter >> 5) << 4, 16)
        grad = np.zeros(nd, np.int64)
        for r in range(8):
            pd = np.where(even, prev_delta & 0xFF, prev_delta)
            pred = sext((pd * coef) >> 8, 8)
            delta = np.full(nd, 31) if r % 2 == 0 else sext(pred + 1, 8)
            if r % 2:
                grad = sext(grad + prev_delta, 8)
            prev_val = (prev_val + delta) & 0xFF
            vals[b * 8 + r] = prev_val
            prev_delta = delta
        counter = sext(counter + (grad >> 2), 16)
    return vals.astype(np.int32)


def check_fire_transform_case(hk: HostKernels, eb: int, nd: int, nb: int,
                              wraps: bool) -> str | None:
    """The host-built transform instantiations at a
    ``FIRE_TRANSFORM_CASES`` case against their plain versions, encode
    and decode over the whole stream: the name of the first that differs,
    or None."""
    import torch

    from sprintz_tpu_torch.models import forecasters as fc

    rng = np.random.default_rng(eb * 101 + nd * 13 + nb)
    half = 1 << (eb - 1)
    if wraps:
        vals = wrapping_transform_rows(eb, nd, nb)
    else:
        vals = np.cumsum(rng.integers(-20, 21, (nb * 8, nd)), axis=0) % (2 * half)
        vals[: nb * 4] = rng.integers(0, 2 * half, (nb * 4, nd))
    rows = torch.from_numpy(vals.astype(np.int32))
    errs = fc.fire_encode_plain(rows, eb, transform=True)
    raw = errs.to(torch.uint8) if eb == 8 else (errs - ((errs & 0x8000) << 1)).to(torch.int16)
    pairs = [("FIRE transform encode", hk.fire_transform(rows, eb, False), errs),
             ("FIRE transform decode", hk.fire_transform(raw, eb, True),
              fc.fire_decode_plain(raw, eb, transform=True))]
    for name, got, want in pairs:
        if got.dtype != want.dtype or not torch.equal(got, want):
            return name
    return None


def fire_chain_states(rng, eb: int, nd: int, n: int) -> np.ndarray:
    """``n`` random (3, D) int32 carries: a value, a delta that may be
    wider than an element, and a counter near the wrap of its width
    (int16 at u8, int32 at u16)."""
    half = 1 << (eb - 1)
    top = (1 << 15) - 1 if eb == 8 else (1 << 31) - 1
    return np.stack([rng.integers(0, 2 * half, (n, nd)),
                     rng.integers(-(1 << 20), 1 << 20, (n, nd)),
                     top - rng.integers(0, 64, (n, nd))], axis=1).astype(np.int32)


def check_fire_carries(hk: HostKernels, eb: int, nd: int, nb: int, trunc: bool,
                       rows, zz, state) -> str | None:
    """The serial scans with carries, as a sharded scan runs them: the
    encode and decode from the zero state and from ``state`` and a
    counter near its wrap, each with its final carry, and the stream
    split in two whose halves, chained through the first half's final
    carry, give the whole (with states too): the name of the first that
    differs from the plain versions, or None."""
    import torch

    from sprintz_tpu_torch.models import forecasters as fc

    rng = np.random.default_rng(eb * 131 + nd * 7 + nb)
    wrap = torch.from_numpy(fire_chain_states(rng, eb, nd, 1)[0])
    pairs = []
    for what, init in (("zero", None), ("carried", state), ("wrapping", wrap)):
        pairs += [
            (f"FIRE encode from the {what} state, final carry",
             hk.fire_encode(rows, eb, trunc, False, init, True),
             fc.fire_encode_plain(rows, eb, trunc, init_state=init, final=True)),
            (f"FIRE encode with states from the {what} state, final carry",
             hk.fire_encode(rows, eb, trunc, True, init, True),
             fc.fire_encode_plain(rows, eb, trunc, True, init, True)),
            (f"FIRE decode from the {what} state, final carry",
             hk.fire_decode(zz, eb, init, trunc, True),
             fc.fire_decode_plain(zz, eb, init, trunc, True))]
    cut = 8 * int(rng.integers(1, nb)) if nb > 1 else 0
    whole_e, whole_f = fc.fire_encode_plain(rows, eb, trunc, final=True)
    whole_v, whole_vf = fc.fire_decode_plain(zz, eb, None, trunc, True)
    if cut:
        e0, f0 = hk.fire_encode(rows[:cut], eb, trunc, False, None, True)
        e1, f1 = hk.fire_encode(rows[cut:], eb, trunc, False, f0, True)
        v0, g0 = hk.fire_decode(zz[:cut], eb, None, trunc, True)
        v1, g1 = hk.fire_decode(zz[cut:], eb, g0, trunc, True)
        pairs += [("FIRE encode chained over two halves",
                   (torch.cat([e0, e1]), f1), (whole_e, whole_f)),
                  ("FIRE decode chained over two halves",
                   (torch.cat([v0, v1]), g1), (whole_v, whole_vf))]
    for name, got, want in pairs:
        for g, w in zip(got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                return name
    return None


def chunk_states(rng, vals: np.ndarray, first: np.ndarray, eb: int, moved: bool):
    """(C, D) int32 delta states at chunk starts ``first`` (blocks) of the
    values ``vals`` (rows, D): the row before each start (0 before row 0),
    so that nothing moves, or with ``moved`` one chunk's (and an empty
    one's, where there is one) changed."""
    st = np.where((first[:-1] > 0)[:, None], vals[np.maximum(first[:-1] * 8 - 1, 0)], 0)
    st = st.astype(np.int64)
    if moved:
        st[rng.integers(0, st.shape[0])] += int(rng.integers(1, 1 << eb))
        empty = np.flatnonzero(first[:-1] == first[1:])
        if empty.size:
            st[empty[0]] -= 7
    return st.astype(np.int32)


def check_chunk_case(hk: HostKernels, eb: int, nd: int, nb: int, first: np.ndarray,
                     seed: int) -> str | None:
    """The host-built chunked delta decode at chunk starts ``first`` (C + 1
    blocks from 0 to nb), from states that continue the stream (nothing
    moves) and from moved ones: K1 and K2 with chunks on a row-major
    payload and, where D fits the lowdim layout, the lowdim decode with
    chunks, against their plain versions and against the serial plain
    decode followed by ``delta_chunk_seed_plain``. The name of the first
    that differs, or None."""
    import torch

    from sprintz_tpu_torch.ops import decode_kernels as dk
    from sprintz_tpu_torch.probes import unpack_cases as uc

    rng = np.random.default_rng(seed)
    cpu = torch.device("cpu")
    dense, widths, _ = uc.unpack_case(rng, eb, nd, nb, "random")
    d, w = uc.to_device(dense, widths, "random", "cpu")
    serial = dk.decode_delta_contiguous(d, w, eb)
    layouts = [("K1 and K2", d, w, serial)]
    if nd * eb <= 32:
        ldense, lwidths, _ = uc.lowdim_case(rng, eb, nd, nb, "random")
        ld, lw = uc.to_device(ldense, lwidths, "random", "cpu")
        layouts.append(("the lowdim decode", ld, lw, dk.decode_delta_lowdim(ld, lw, eb)))
    for what, dd, ww, ser in layouts:
        for moved in (False, True):
            st = chunk_states(rng, dk.widen(ser).numpy(), first, eb, moved)
            ck = dk.delta_chunks(first, st, nb, nd, cpu)
            seeded = dk.delta_chunk_seed_plain(ser, first * 8, st, eb)
            name = f"{what}, chunks {'moved' if moved else 'continuing'}"
            if what == "K1 and K2":
                bz, toff = dk.unpack_zz_plain(dd, ww, eb, ck)
                got_bz, got_toff = hk.unpack(dd, ww, eb, 0, (first, st))
                bz2 = bz.reshape(-1, nd)
                pairs = [(name + ": K1 deltas", got_bz, bz),
                         (name + ": K1 tile offsets", got_toff, toff),
                         (name + ": K2", hk.prefix_finish(bz2, toff, eb, (first, st)),
                          dk.prefix_finish_plain(bz2, toff, eb, ck))]
                plain = dk.decode_delta_contiguous(dd, ww, eb, ck)
            else:
                plain = dk.decode_delta_lowdim(dd, ww, eb, ck)
                pairs = [(name, hk.decode_lowdim(dd, ww, eb, 0, (first, st)), plain)]
            pairs.append((name + ": plain against serial + seed", plain, seeded))
            if not moved:
                pairs.append((name + ": values from continuing states", plain, ser))
            for n_, got, want in pairs:
                if got.dtype != want.dtype or not torch.equal(got, want):
                    return n_
    return None


def check_seed_case(hk: HostKernels, eb: int, nd: int, nb: int,
                    nchunks: int) -> str | None:
    """``check_chunk_case`` at a ``SEED_CASES`` case: chunks of unequal
    lengths (empty ones too) from ``chunk_cuts``."""
    rng = np.random.default_rng(eb * 13 + nd * 7 + nb + nchunks)
    return check_chunk_case(hk, eb, nd, nb, chunk_cuts(rng, nb, nchunks),
                            eb * 17 + nd + nb * 5 + nchunks)


def short_case(eb: int, nd: int, nb: int, chunks, trunc: bool):
    """A ``SHORT_CASES`` case's errors (of a walk, on the CPU), chunk starts
    and random states (deltas wider than an element in one chunk)."""
    import torch

    from sprintz_tpu_torch.models import forecasters as fc

    rng = np.random.default_rng([eb, nd, nb])
    half = 1 << (eb - 1)
    x = (np.cumsum(rng.integers(-9, 10, (nb * 8, nd)), 0) % (2 * half)).astype(np.int32)
    errs = fc.fire_encode(torch.from_numpy(x), eb, trunc)
    zz = errs.to(torch.uint8) if eb == 8 else errs
    first = (chunk_cuts(rng, nb, chunks) if isinstance(chunks, int)
             else np.asarray(chunks, dtype=np.int64))
    c = first.size - 1
    states = np.stack([rng.integers(0, 2 * half, (c, nd)),
                       rng.integers(-half, half, (c, nd)),
                       rng.integers(-(1 << 15), 1 << 15, (c, nd))], axis=1)
    states[c // 2, 1] = rng.integers(-(1 << 20), 1 << 20, nd)
    return zz, first, torch.from_numpy(states.astype(np.int32))


def check_query_case(hk: HostKernels, eb: int, nd: int, rows: int) -> str | None:
    """The host-built reduce at a ``QUERY_CASES`` case, each op, the sum
    also with run gaps after the blocks (up to 2^31 - 1 rows, where rows
    are whole blocks) and min also after a leading run, against its plain
    version: the name of the first that differs, or None."""
    import torch

    from sprintz_tpu_torch.ops import decode_kernels as dk
    from sprintz_tpu_torch.ops import query_kernels as qk

    rng = np.random.default_rng(eb * 101 + nd * 7 + rows)
    top = 1 << eb
    x = rng.integers(top - top // 64, top, (rows, nd)).astype(np.int32)
    x[rng.integers(0, rows, 3), rng.integers(0, nd, 3)] = 0  # a few zeros for min
    vals = dk.narrow(torch.from_numpy(x), eb).to(hk.device)
    calls = [(op, None, False) for op in qk.OPS] + [("min", None, True)]
    if rows % 8 == 0:
        gaps = rng.integers(0, 1 << 20, rows // 8).astype(np.int32)
        gaps[rng.integers(0, rows // 8)] = (1 << 31) - 1
        calls.append(("sum", gaps, False))
    for op, gaps, lead in calls:
        got = hk.reduce_cols(vals, op, gaps, lead)
        want = qk.reduce_cols_plain(vals, op, gaps, lead)
        if got.dtype != want.dtype or not torch.equal(got, want):
            return f"reduce_cols {op}" + (" with gaps" if gaps is not None else "") + (
                " after a leading run" if lead else "")
    return None


def epilogue_case(eb: int, nd: int, nb: int, values: str, device="cpu"):
    """An ``EPILOGUE_CASES`` case: its values (nb * 8, D) (a walk from 0, or
    near the top of the range, where a leading run moves min), K2's inputs for them (the
    biased deltas and tile offsets), the lowdim payload where D fits it, and
    gaps after the blocks (one near 2^31); tensors on ``device``."""
    import torch

    from sprintz_tpu_torch.ops import decode_kernels as dk
    from sprintz_tpu_torch.ops import pack_kernels as pk
    from sprintz_tpu_torch.probes import encode_cases as ec

    rng = np.random.default_rng([eb, nd, nb])
    top = 1 << eb
    if values == "walk":
        x = np.cumsum(rng.integers(-9, 10, (nb * 8, nd)), axis=0) % top
    else:
        x = rng.integers(top - top // 64, top, (nb * 8, nd))
    d = (np.diff(x, axis=0, prepend=0) + top // 2) % top - top // 2
    u = torch.from_numpy(((d << 1) ^ (d >> 63)).astype(np.int32)).reshape(nb, 8, nd)
    bz, toff = (t.to(device) for t in dk.zz_and_offsets(u, eb))
    lowdim = None
    if nd * eb <= 32:
        narrow = x.astype(np.uint8 if eb == 8 else np.uint16)
        widths, _, dense, _ = pk.encode_lowdim_plain(ec.rows_tensor(narrow), eb // 8)
        lowdim = (dense.to(device), widths.to(device))
    gaps = rng.integers(0, 1 << 20, nb).astype(np.int32)
    gaps[rng.integers(0, nb)] = CASE_GAPS_TOP
    return x, (bz.reshape(-1, nd), toff), lowdim, gaps


def check_epilogue_case(hk: HostKernels, eb: int, nd: int, nb: int,
                        values: str) -> str | None:
    """The host-built K2 and lowdim decode with the reduce epilogue at an
    ``EPILOGUE_CASES`` case against their plain versions (the plain decode,
    then ``reduce_cols_plain``), each op with and without store, the sum
    with gaps, min after a leading run; the plain decode must give the
    case's values. The name of the first that differs, or None."""
    import torch

    from sprintz_tpu_torch.ops import decode_kernels as dk
    from sprintz_tpu_torch.ops import query_kernels as qk

    x, (bz, toff), lowdim, gaps = epilogue_case(eb, nd, nb, values, hk.device)
    calls = [("sum", None, False, True), ("sum", gaps, False, False),
             ("sum", gaps, True, True), ("max", None, False, False),
             ("max", None, True, True), ("min", None, False, True),
             ("min", None, True, False)]
    layouts = []
    if lowdim is None or nb <= 100:
        layouts.append(("K2", lambda *a: hk.prefix_finish_reduce(bz, toff, eb, *a),
                        lambda *a: qk.prefix_finish_reduce_plain(bz, toff, eb, *a)))
    if lowdim is not None:
        layouts.append(("the lowdim decode",
                        lambda *a: hk.decode_lowdim_reduce(*lowdim, eb, *a),
                        lambda *a: qk.decode_lowdim_reduce_plain(*lowdim, eb, *a)))
    for name, kern, plain in layouts:
        got_x = plain("max", None, False, True)[0]
        if not np.array_equal(dk.widen(got_x).cpu().numpy(), x):
            return f"{name}'s plain decode of the case"
        for op, g, lead, store in calls:
            got, want = kern(op, g, lead, store), plain(op, g, lead, store)
            what = (f"{name} with the reduce epilogue: {op}"
                    + (" with gaps" if g is not None else "")
                    + (" after a leading run" if lead else "")
                    + (", store" if store else ""))
            if (got[0] is None) != (want[0] is None) or (
                    got[0] is not None and not torch.equal(got[0], want[0])):
                return what + ": values"
            if got[1].dtype != want[1].dtype or not torch.equal(got[1], want[1]):
                return what + ": result"
    return None


def check_pack_case(hk: HostKernels, nd: int, es: int, nb: int | None = None) -> str | None:
    """The host-built lowdim encode from the rows and from the errors
    (``nb`` given: a ``LOWDIM_PACK_CASES`` case) or K3 (a ``PACK_CASES``
    case) against its plain version: the name of the first that differs,
    or None."""
    import torch

    from sprintz_tpu_torch.ops import pack_kernels as pk
    from sprintz_tpu_torch.probes import encode_cases as ec

    rng = np.random.default_rng(nd * 31 + es * 7 + (nb or 0))
    if nb is None:
        errs, widths = (torch.from_numpy(a) for a in ec.pack_case(rng, nd, es))
        pairs = [("K3", (hk.pack_rows(errs, widths, es),),
                  (pk.pack_rows_plain(errs, widths, es),))]
    else:
        rows, errs = ec.lowdim_rows_case(rng, nd, es, nb)
        rows, errs = ec.rows_tensor(rows), torch.from_numpy(errs)
        pairs = [("lowdim encode from rows", hk.encode_lowdim(rows, es, False),
                  pk.encode_lowdim_plain(rows, es)),
                 ("lowdim encode from errors", hk.encode_lowdim(errs, es, True),
                  pk.encode_lowdim_plain(errs, es, True))]
    for name, got, want in pairs:
        if not all(g.dtype == v.dtype and torch.equal(g, v) for g, v in zip(got, want)):
            return name
    return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--resident", type=int, nargs="+", default=[1, 3])
    ap.add_argument("--src", type=pathlib.Path, default=SRC,
                    help="the decode.cu to build (default: the checkout's)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from sprintz_tpu_torch.probes import unpack_cases as uc

    from sprintz_tpu_torch.probes import encode_cases as ec

    so = build(args.src)
    so_pack = build_pack()
    so_fire = build_fire()
    so_query = build_query()

    def report(what, bad, good):
        print(f"[host] {what}: " + (f"{bad} differs from its plain version" if bad
                                    else good), flush=True)
        return bool(bad)

    for resident in args.resident:
        hk = HostKernels(so, resident)
        for case in uc.UNPACK_CASES:
            what = "u{} D {} nb {} {}, {} resident".format(*case, resident)
            if report(what, check_case(hk, *case), "K1, K4" + (", K5" if case[0] == 8 else "")
                      + " and K2 equal their plain versions"):
                return 1
        for case in uc.LOWDIM_CASES:
            what = "lowdim u{} D {} nb {} {}, {} resident".format(*case, resident)
            if report(what, check_lowdim_case(hk, *case),
                      "the lowdim decode (both modes) equals its plain versions"):
                return 1
        for case in uc.SEED_CASES:
            what = "chunked decode u{} D {} nb {} chunks {}, {} resident".format(*case, resident)
            if report(what, check_seed_case(hk, *case), "equals its plain versions"):
                return 1
        for name, eb, nd, nb, first in uc.CHUNK_CASES:
            what = f"chunked decode u{eb} D {nd} nb {nb}, {name}, {resident} resident"
            if report(what, check_chunk_case(hk, eb, nd, nb, np.asarray(first), nb + nd),
                      "equals its plain versions"):
                return 1
        hf = HostKernels(so_fire, resident)
        for case in FIRE_CASES:
            what = "FIRE u{} D {} nb {} chunks {} trunc {}, {} resident".format(*case, resident)
            if report(what, check_fire_case(hf, *case),
                      "the encode (with states) and both decodes equal their plain versions"):
                return 1
        for case in FIRE_TRANSFORM_CASES:
            what = "FIRE transform u{} D {} nb {} wraps {}, {} resident".format(*case, resident)
            if report(what, check_fire_transform_case(hf, *case),
                      "encode and decode equal their plain versions"):
                return 1
        hq = HostKernels(so_query, resident)
        for case in QUERY_CASES:
            what = "reduce u{} D {} rows {}, {} resident".format(*case, resident)
            if report(what, check_query_case(hq, *case),
                      "every op equals its plain version"):
                return 1
        for case in EPILOGUE_CASES:
            what = "reduce epilogue u{} D {} nb {} {}, {} resident".format(*case, resident)
            if report(what, check_epilogue_case(hk, *case),
                      "every op, store and gap setting equals its plain version"):
                return 1
        hp = HostKernels(so_pack, resident)
        for nd, es in ec.PACK_CASES:
            if report(f"K3 D {nd} u{8 * es}, {resident} resident",
                      check_pack_case(hp, nd, es), "equals its plain version"):
                return 1
        for nd, es, nb in ec.LOWDIM_PACK_CASES:
            if report(f"lowdim encode D {nd} u{8 * es} nb {nb}, {resident} resident",
                      check_pack_case(hp, nd, es, nb),
                      "equals its plain version from rows and from errors"):
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
