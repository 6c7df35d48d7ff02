#!/usr/bin/env python3
"""Build the delta decode's kernels (``csrc/decode.cu``: K1/K4/K5
``unpack_zz_kernel``, K2 ``prefix_finish_kernel`` and the lowdim decode
``decode_lowdim_kernel``) and the encode kernels (``csrc/pack.cu``: K3
``pack_rows_kernel`` and the lowdim ``encode_lowdim_kernel``) on the host
with g++, and hold them to their plain versions at the cases of
``probes/unpack_cases.py`` (``UNPACK_CASES``, ``LOWDIM_CASES``) and
``probes/encode_cases.py`` (``PACK_CASES``, ``LOWDIM_PACK_CASES``), with
no card and no nvcc.

    python3 sprintz_tpu_torch/probes/host_build.py [--resident 1 3] [--src FILE]

A source is compiled as C++ against ``host_shim.h``: its launches
become calls that run each CUDA thread as a std::thread, ``resident``
CTAs at a time (more than one, so that a look-back waits on tiles or
spans that run beside it); its device helpers (``cp.async``, the status
words) are replaced between their marker lines by copies that land when a
wait covers their group, and C++ atomics. Shared memory and every output
start as garbage, so a byte the kernel fails to write, or reads before
its copy lands, shows; the lowdim decode's status words start zeroed, as
the wrapper keeps them, and must be zeroed again after each launch. The C
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
ENTRY = """
extern "C" void sprintz_shim_set_resident(int n) { g_resident = n; }
extern "C" int sprintz_shim_fault() { return g_fault.exchange(0); }
"""


# the C entry points' argtypes, as ops/_build.py binds them
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ENTRIES = {
    "sprintz_unpack_zz": [P, P, P, P, P, L, I, I, I, I, P],
    "sprintz_prefix_finish": [P, P, P, L, I, I, P],
    "sprintz_decode_lowdim": [P, P, P, P, L, I, I, I, P],
    "sprintz_pack_rows": [P, P, P, L, I, I, I, P],
    "sprintz_encode_lowdim": [P, P, P, P, P, L, I, I, I, P],
}


def host_source(src: str, kernels: int) -> str:
    """A kernel source as C++ for the shim: its device helpers, its shared
    memory, its ``kernels`` launches."""
    out, n = HELPERS.subn(HOST_HELPERS, src)
    assert n == 1, "the device helpers' marker lines"
    out = out.replace("#include <cuda_runtime.h>\n", "")
    out, n = re.subn(r"extern __shared__ __align__\(16\) uint8_t smem\[\];",
                     "uint8_t* smem = shim_smem();", out)
    out, m = re.subn(r"extern __shared__ uint4 smem\[\];",
                     "uint4* smem = reinterpret_cast<uint4*>(shim_smem());", out)
    assert n + m <= kernels, "a dynamic shared buffer a kernel at most"
    out, n = re.subn(r"(\w+<[^<>;]*>)<<<(.*?)>>>\(", r"shim_launch(\1, \2, ", out,
                     flags=re.S)
    assert n == kernels, "one launch a kernel"
    return out + ENTRY


def build(src: pathlib.Path = SRC, out: pathlib.Path = OUT,
          kernels: int = 3) -> ctypes.CDLL:
    """Compile ``src`` for the shim into ``out`` (reused while the source
    and the shim are unchanged) and load it."""
    text = host_source(src.read_text(), kernels)
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


class HostKernels:
    """The wrappers' calls of the C entry points, on CPU tensors."""

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

    def unpack(self, dense, widths, elem_bits: int, raw: int):
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
            nb, nd, maxb, elem_bits, raw, None))
        return out if raw else (out, toff)

    def decode_lowdim(self, dense, widths, elem_bits: int, raw: int):
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
            None if raw else status.data_ptr(), nb, nd, elem_bits, raw, None))
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

    def prefix_finish(self, bz, toff, elem_bits: int):
        from sprintz_tpu_torch.ops import decode_kernels as dk

        out = self.garbage(tuple(bz.shape), bz.dtype)
        bz, toff = dk.aligned16(bz), dk.aligned16(toff)
        self.check(self.so.sprintz_prefix_finish(
            bz.data_ptr(), toff.data_ptr(), out.data_ptr(), bz.shape[0], bz.shape[1],
            elem_bits, None))
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
