#!/usr/bin/env python3
"""Time the delta decode's two hand kernels, the unpack kernel (K1
``unpack_zz``, K4 ``unpack_rows``, K5 its narrow mode) and K2
``prefix_finish``, against an earlier version of ``csrc/decode.cu`` on the
same card, in one process.

Run from the root of a checkout on a machine with a CUDA card and nvcc,
with the earlier ``csrc`` directory unpacked somewhere, e.g.:

    git archive 3b4f285 sprintz_tpu_torch/csrc | tar -x -C build/parent
    python3 sprintz_tpu_torch/probes/unpack_ab.py \\
        --old build/parent/sprintz_tpu_torch/csrc

It builds the earlier ``decode.cu`` (whose unpack kernel takes i32 widths
and the widths' exclusive prefix, which its wrapper computed with a
``torch.cumsum`` and a subtraction, and whose K1 wrote tile totals that a
``torch.cumsum`` turned into offsets) and variants of the current one
(VARIANTS) into ``build/sprintz_tpu_torch/probes/``. At the main path's
shapes (the 8 MiB u8 and u16 random walks and the 64 MiB u8 walk, their
payloads as the decoder uploads them) it checks that every version
equals the plain one, then times them in turns (earlier, current,
current, earlier): CUDA events around the wrapper and around each of its
kernel launches, median of 25 after warm-up, the L2 flushed before each by
writing 1 GiB, as ``chip_smoke.py`` does. Beside them, alone: the widths'
``torch.cumsum`` and subtraction, their widening to i32,
``exclusive_offsets`` over the tile totals and a memset of K1's status
words; clock64 counters of K1's and K5's phases (a variant's
``[phases]`` lines); and the 8 MiB u8 delta decode's device pass, now and
with the earlier kernels, by the host's clock and by torch.profiler
(``[device pass]`` lines). The last line is a JSON object of every time.

Not part of the port's path and not imported by it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
OUT = ROOT / "build" / "sprintz_tpu_torch" / "probes"
REPS = 25
BULK_HELPERS = r"""
__device__ __forceinline__ void bulk_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread copies the 16-byte units of [g0, g0 + len) that lie inside
// gtot's whole units with one bulk copy that completes on `bar`, and the
// bytes of a last partial unit itself.
__device__ __forceinline__ void bulk_issue(uint8_t* img, const uint8_t* src, int64_t g0,
                                           int len, int64_t gtot, int tid, uint64_t* bar) {
  if (tid != 0) return;
  const int64_t a = g0 & ~(int64_t)15;
  const int64_t e = (g0 + len + 15) & ~(int64_t)15;
  const int64_t eb = e <= gtot ? e : (gtot & ~(int64_t)15);
  const uint32_t bytes = (uint32_t)(eb - a);
  const uint32_t sbar = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(sbar),
               "r"(bytes) : "memory");
  if (bytes) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"((uint32_t)__cvta_generic_to_shared(img)),
        "l"(src + a), "r"(bytes), "r"(sbar) : "memory");
  }
  for (int64_t g = eb; g < gtot && g < e; ++g) img[g - a] = src[g];
}

__device__ __forceinline__ void bulk_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"((uint32_t)__cvta_generic_to_shared(bar)), "r"(parity)
                 : "memory");
  } while (!done);
}
"""
PHASE_HELPERS = r"""
__device__ unsigned long long g_phase[16];  // cycles a phase, summed over CTAs; [15]: CTAs
#define PHASE(k)                                   \
  if (threadIdx.x == 0) {                          \
    const unsigned long long c_ = clock64();       \
    atomicAdd(&g_phase[k], c_ - ck);               \
    ck = c_;                                       \
  }
"""
PHASE_ENTRY = r"""
extern "C" int sprintz_phase_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
}
extern "C" int sprintz_phase_zero() {
  static const unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
"""
# the phases of K1 that the phase counters time, by thread 0 of each CTA
PHASES = ("ticket", "stage (first group)", "scan", "extract (both groups)",
          "publish and store", "look-back")
# Variants of the current decode.cu: (what it changes, [(text, replacement)])
VARIANTS = {
    # K1 writes its tile totals, which the wrapper scans with
    # exclusive_offsets (the earlier pipeline's scan) in place of the
    # look-back; the entry point zeroes only the ticket
    "K1 totals, then exclusive_offsets": [
        ("(int32_t)look_back(status, tile, ndims, d0 + jj, s_tot[jj]);", "(int32_t)s_tot[jj];"),
        ("err = cudaMemsetAsync(status, 0, (size_t)(ntiles * ndims + 1) * sizeof(*status), s);",
         "err = cudaMemsetAsync(status + ntiles * ndims, 0, sizeof(*status), s);")],
    # K1 stages a contiguous tile with one TMA bulk copy and an mbarrier,
    # all of it before the first wait, in place of two groups of 16-byte
    # cp.async copies
    "K1 staged by a bulk copy": [
        ("// ---- end of device helpers\n",
         "// ---- end of device helpers\n" + BULK_HELPERS),
        ("  int32_t* s_tile = s_boff + TILE_BLOCKS;\n",
         "  int32_t* s_tile = s_boff + TILE_BLOCKS;\n  __shared__ uint64_t s_bar;\n"
         "  if (threadIdx.x == 0) bulk_init(&s_bar);\n"),
        ("        stage_range(s_in + (int)((g & ~(int64_t)15) - ((row0 * maxb) & ~(int64_t)15)), dense,\n"
         "                    g, (int)(e - g), gtot, tid, THREADS);",
         "        if (r_lo == 0) bulk_issue(s_in, dense, row0 * maxb, rows * maxb, gtot, tid, &s_bar);"),
        ("    cp_async_wait_prior();\n    __syncthreads();\n    if (sb < nbt)",
         "    if (CONTIG) bulk_wait(&s_bar, 0);\n    cp_async_wait_prior();\n"
         "    __syncthreads();\n    if (sb < nbt)")],
    # the status words by relaxed loads and stores at the card's scope in
    # place of volatile ones
    "K1 status words relaxed": [
        ("  return *reinterpret_cast<const volatile unsigned long long*>(p);",
         "  unsigned long long v;\n"
         "  asm volatile(\"ld.relaxed.gpu.global.u64 %0, [%1];\" : \"=l\"(v) : \"l\"(p) : \"memory\");\n"
         "  return v;"),
        ("  *reinterpret_cast<volatile unsigned long long*>(p) = v;",
         "  asm volatile(\"st.relaxed.gpu.global.u64 [%0], %1;\" :: \"l\"(p), \"l\"(v) : \"memory\");")],
    # the status words the look-back reads at once
    "K1 look-back of 8 words": [
        ("constexpr int LOOK_BACK = 4;", "constexpr int LOOK_BACK = 8;")],
    "K1 look-back of 2 words": [
        ("constexpr int LOOK_BACK = 4;", "constexpr int LOOK_BACK = 2;")],
    "K1 look-back of 1 word": [
        ("constexpr int LOOK_BACK = 4;", "constexpr int LOOK_BACK = 1;")],
    # the scan's rows of offsets unpadded: a lane writes a segment of
    # words, so lanes 4 segments apart write to one bank
    "K1 offsets unpadded": [
        ("  const int ow_stride = p.dc + 1;", "  const int ow_stride = p.dc;")],
    # a poll of an unpublished word sleeps first, so that waiting CTAs
    # take fewer issue slots and L2 requests from those still working
    # K2's runs: rows a thread sums and then walks
    "K2 runs of 32 rows": [
        ("constexpr int RUN_ROWS = 64;", "constexpr int RUN_ROWS = 32;")],
    "K2 runs of 128 rows": [
        ("constexpr int RUN_ROWS = 64;", "constexpr int RUN_ROWS = 128;")],
    # clock64 counters of K1's phases (PHASES)
    "K1 phase counters": [
        ("// ---- end of device helpers\n",
         "// ---- end of device helpers\n" + PHASE_HELPERS),
        ("  int64_t tile = blockIdx.x;\n",
         "  unsigned long long ck = clock64();\n  if (threadIdx.x == 0) atomicAdd(&g_phase[15], 1ull);\n"
         "  int64_t tile = blockIdx.x;\n"),
        ("    tile = *s_tile;\n", "    tile = *s_tile;\n    PHASE(0);\n"),
        ("    cp_async_wait_prior();\n    __syncthreads();\n    if (sb < nbt)",
         "    cp_async_wait_prior();\n    __syncthreads();\n    PHASE(1);\n    if (sb < nbt)"),
        ("      carry += __shfl_sync(smask, incl, SCAN_LANES - 1, SCAN_LANES);\n    }\n"
         "    __syncthreads();\n",
         "      carry += __shfl_sync(smask, incl, SCAN_LANES - 1, SCAN_LANES);\n    }\n"
         "    __syncthreads();\n    PHASE(2);\n"),
        ("    extract(half, nbt);\n    __syncthreads();\n",
         "    extract(half, nbt);\n    __syncthreads();\n    PHASE(3);\n"),
        ("    if (!RAW && !CHUNKED) {\n      for (int jj = tid; jj < dc; jj += THREADS) {\n"
         "        tile_off[",
         "    PHASE(4);\n    if (!RAW && !CHUNKED) {\n"
         "      for (int jj = tid; jj < dc; jj += THREADS) {\n        tile_off["),
        ("    if (sl == 0 && sb < nbt) s_boff[sb] = carry;",
         "    __syncthreads();\n    PHASE(5);\n    if (sl == 0 && sb < nbt) s_boff[sb] = carry;"),
        ("}  // extern \"C\"\n", "}  // extern \"C\"\n" + PHASE_ENTRY)],
}


def slug(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=pathlib.Path,
                    help="the earlier csrc directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("unpack_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from sprintz_tpu_torch import decoder, encoder
    from sprintz_tpu_torch.ops import _build
    from sprintz_tpu_torch.ops import decode_kernels as dk
    from sprintz_tpu_torch.ops import pack_kernels as pk
    from sprintz_tpu_torch.stream_format import read_metadata_rle

    dev = torch.device("cuda")
    OUT.mkdir(parents=True, exist_ok=True)
    srcs = {"old": args.old / "decode.cu"}
    for name, edits in VARIANTS.items():
        src = (_build.CSRC / "decode.cu").read_text()
        for old, new in edits:
            assert src.count(old) == 1, (name, old)
            src = src.replace(old, new)
        path = OUT / f"var_{slug(name)}.cu"
        path.write_text(src)
        srcs[name] = path
    procs = {k: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{slug(k)}.so"),
         str(p)], stdout=subprocess.DEVNULL) for k, p in srcs.items()}
    _build.build()
    failed = [k for k, p in procs.items() if p.wait()]
    if failed:
        raise RuntimeError(f"nvcc failed: {failed}")
    libs = {k: ctypes.CDLL(str(OUT / f"{slug(k)}.so")) for k in srcs}
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs["old"].sprintz_unpack_zz.argtypes = [P, P, P, P, P, L, I, I, I, I, I, P]
    libs["old"].sprintz_prefix_finish.argtypes = [P, P, P, L, I, I, I, P]
    for k in VARIANTS:
        libs[k].sprintz_unpack_zz.argtypes = [P, P, P, P, P, L, I, I, I, I, P, I, P, P]
        libs[k].sprintz_prefix_finish.argtypes = [P, P, P, L, I, I, P, I, P, P]
    counters = libs["K1 phase counters"]
    counters.sprintz_phase_read.argtypes = [P]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    events = []  # (start, end) CUDA events around each launch of a timed call
    per_launch = [[]]  # the last time_ms's median of each launch

    def call(fn, *a):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        err = fn(*a, torch.cuda.current_stream().cuda_stream)
        e.record()
        events.append((s, e))
        if err:
            raise RuntimeError(f"CUDA error {err}")

    launch = _build.launch

    def timed_launch(name, like, *a):
        stem, _ = _build.SIGNATURES[name]
        call(getattr(_build._libraries()[stem], name), *a)

    _build.launch = timed_launch

    # the earlier wrappers, from i32 widths as the earlier decoder uploaded
    # them
    def old_unpack(dense, w32, eb, raw, narrow=False):
        nb, _, maxb = dense.shape
        nd = w32.shape[1]
        ntiles = -(-nb // dk.TILE_BLOCKS)
        odt = (torch.uint8 if narrow else torch.int32) if raw else dk.narrow_dtype(eb)
        out = torch.empty((nb, 8, nd), dtype=odt, device=dev)
        tots = None if raw else torch.empty((ntiles, 1, nd), dtype=torch.int32, device=dev)
        off = torch.cumsum(w32, dim=1, dtype=torch.int32) - w32
        call(libs["old"].sprintz_unpack_zz, dense.data_ptr(), w32.data_ptr(), off.data_ptr(),
             out.data_ptr(), None if raw else tots.data_ptr(), nb, nd, maxb, dk.TILE_BLOCKS,
             (8 if narrow else 16) if raw else eb, int(raw))
        return out if raw else (out, tots)

    def old_finish(bz, toff, eb):
        out = torch.empty_like(bz)
        call(libs["old"].sprintz_prefix_finish, bz.data_ptr(), toff.data_ptr(),
             out.data_ptr(), bz.shape[0], bz.shape[1], dk.TILE_ROWS, eb)
        return out

    def old_chain(dense, w32, eb):
        bz, tots = old_unpack(dense, w32, eb, False)
        return old_finish(bz.reshape(-1, w32.shape[1]), dk.exclusive_offsets(tots), eb)

    def device_pass(key, dense, w8, eb) -> dict:
        """The delta decode's device pass on the uploaded payload, as the
        path runs it now (decoder.decode_device) and as it ran with the
        earlier kernels (the widths widened to i32, the widths' cumsum,
        exclusive_offsets between K1 and K2): host-clock ms to a
        synchronize (median of REPS), and torch.profiler's device time a
        call by kernel over REPS calls."""
        nrows = dense.shape[0] * 8
        out_rows = torch.arange(dense.shape[0], device=dev) * 8
        fns = {"current": lambda: decoder.decode_device(dense, w8, out_rows, nrows, eb // 8),
               "earlier": lambda: old_chain(dense, w8.to(torch.int32), eb)}
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        res = {}
        for k, fn in fns.items():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            host = []
            for _ in range(REPS):
                c = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - c) * 1e3)
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(REPS):
                    fn()
                torch.cuda.synchronize()
            by_kernel = {}
            for e in prof.key_averages():
                us = (getattr(e, "self_device_time_total", None)
                      or getattr(e, "self_cuda_time_total", 0))
                if us > 0:
                    by_kernel[e.key] = us / REPS / 1e3
            res[k] = {"host_ms": statistics.median(host), "device_ms": by_kernel}
            print(f"[device pass] {key} {k}: {res[k]['host_ms']:.4f} ms to a synchronize "
                  f"(host clock); device ms a call: "
                  + "; ".join(f"{n} {t:.4f}" for n, t in sorted(by_kernel.items(),
                                                               key=lambda x: -x[1])),
                  flush=True)
        return res

    def phases(what, fn):
        """Mean cycles a CTA in each of K1's phases (PHASES), one run of
        fn after a warm-up, the L2 flushed before it."""
        fn()
        flush.zero_()
        torch.cuda.synchronize()
        counters.sprintz_phase_zero()
        fn()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        counters.sprintz_phase_read(ctypes.addressof(buf))
        ctas = max(1, buf[15])
        res = {name: buf[i] / ctas for i, name in enumerate(PHASES)}
        print(f"[phases] {what}, cycles a CTA over {buf[15]} CTAs: "
              + ", ".join(f"{k} {v:.0f}" for k, v in res.items()), flush=True)
        return res

    def variant_k1(lib, scan):
        """K1 from a variant library; `scan`: its outputs are tile totals,
        which exclusive_offsets turns into offsets."""
        def fn(dense, w8, eb):
            nb, _, maxb = dense.shape
            nd = w8.shape[1]
            ntiles = -(-nb // dk.TILE_BLOCKS)
            bz = torch.empty((nb, 8, nd), dtype=dk.narrow_dtype(eb), device=dev)
            toff = torch.empty((ntiles, 1, nd), dtype=torch.int32, device=dev)
            status = torch.empty(ntiles * nd + 1, dtype=torch.int64, device=dev)
            call(lib.sprintz_unpack_zz, dense.data_ptr(), w8.data_ptr(), bz.data_ptr(),
                 toff.data_ptr(), status.data_ptr(), nb, nd, maxb, eb, 0, None, 0, None)
            return bz, dk.exclusive_offsets(toff) if scan else toff
        return fn

    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)

    def time_ms(fn) -> tuple[float, float]:
        """(wrapper ms, ms inside its launches), medians of REPS."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        whole, inside, each = [], [], []
        for _ in range(REPS):
            flush.zero_()
            events.clear()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            whole.append(s.elapsed_time(e))
            each.append([a.elapsed_time(b) for a, b in events])
            inside.append(sum(each[-1]))
        per_launch[0] = [statistics.median(x) for x in zip(*each)]
        return statistics.median(whole), statistics.median(inside)

    def same(what, want, *gots):
        torch.cuda.synchronize()
        for got in gots:
            for a, b in zip(want if isinstance(want, tuple) else [want],
                            got if isinstance(got, tuple) else [got]):
                if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
                    raise AssertionError(f"{what}: a version differs from the plain one")

    def ab(what, fns: dict) -> dict:
        """Time fns in turns: each in order, then each in reverse order."""
        runs = {k: [] for k in fns}
        launches = {}
        for k in list(fns) + list(fns)[::-1]:
            runs[k].append(time_ms(fns[k]))
            launches[k] = per_launch[0]
        res = {k: [statistics.mean(x[i] for x in v) for i in (0, 1)]
               for k, v in runs.items()}
        for k, (ms, kms) in res.items():
            print(f"[ab] {what} {k}: {ms:.4f} ms (inside its launches {kms:.4f} ms: "
                  + ", ".join(f"{t:.4f}" for t in launches[k]) + ")", flush=True)
        return res

    def alone(what, fn) -> float:
        ms, _ = time_ms(fn)
        print(f"[ab] {what}: {ms:.4f} ms", flush=True)
        return ms

    rng = np.random.default_rng(0)
    walk = {  # name -> (nrows, elem_sz)
        "u8 walk 8 MiB": (1 << 17, 1), "u16 walk 8 MiB": (1 << 16, 2),
        "u8 walk 64 MiB": (1 << 20, 1)}
    result = {"card": smi}
    for what, (nrows, es) in walk.items():
        eb = 8 * es
        x = (np.cumsum(rng.integers(-6, 7, (nrows, 64)), axis=0) % (1 << eb)
             ).astype(np.uint8 if es == 1 else np.uint16)
        buf = encoder.compress(x.reshape(-1), 64, device=dev)
        ng, _, _ = read_metadata_rle(buf)
        idx = decoder.walk_headers(buf, ng, 64, es)
        dense, w8, _ = decoder.upload_payload(decoder.gather_payloads(buf, idx), idx, dev)
        w32 = w8.to(torch.int32)
        key = f"{what} (nb {dense.shape[0]}, MAXB {dense.shape[2]})"
        tots_var = variant_k1(libs["K1 totals, then exclusive_offsets"], False)(dense, w8, eb)[1]

        k1 = {"earlier": lambda: old_unpack(dense, w32, eb, False),
              "current": lambda: dk.unpack_zz(dense, w8, eb)}
        for k in VARIANTS:
            if k.startswith("K1"):
                k1[k] = (lambda f: lambda: f(dense, w8, eb))(
                    variant_k1(libs[k], k.startswith("K1 totals")))
        plain = dk.unpack_zz_plain(dense, w8, eb)
        old_bz, old_tots = k1["earlier"]()
        same(f"K1 {key}", plain, (old_bz, dk.exclusive_offsets(old_tots)),
             *[f() for k, f in k1.items() if k != "earlier"])
        result[f"unpack_zz {key}"] = ab(f"unpack_zz {key}", k1)
        result[f"widths cumsum {key}"] = alone(
            f"the widths' torch.cumsum and subtraction alone {key}",
            lambda: torch.cumsum(w32, dim=1, dtype=torch.int32) - w32)
        result[f"widen widths {key}"] = alone(f"the widths' widening to i32 alone {key}",
                                              lambda: w8.to(torch.int32))
        result[f"exclusive_offsets {key}"] = alone(
            f"exclusive_offsets over the tile totals alone {key}",
            lambda: dk.exclusive_offsets(tots_var))
        status = torch.empty(tots_var.numel() + 1, dtype=torch.int64, device=dev)
        result[f"status memset {key}"] = alone(
            f"a memset of K1's status words alone {key}", status.zero_)
        result[f"phases K1 {key}"] = phases(
            f"K1 {key}", lambda: variant_k1(counters, False)(dense, w8, eb))

        def k5_counted():
            out = torch.empty(dense.shape[:2] + (64,), dtype=torch.uint8, device=dev)
            call(counters.sprintz_unpack_zz, dense.data_ptr(), w8.data_ptr(),
                 out.data_ptr(), None, None, dense.shape[0], 64, dense.shape[2], 8, 1,
                 None, 0, None)
        if es == 1:
            result[f"phases K5 {key}"] = phases(f"K5 {key}", k5_counted)

        bz, toff = plain
        bz = bz.reshape(-1, 64)
        k2 = {"earlier": lambda: old_finish(bz, toff, eb),
              "current": lambda: dk.prefix_finish(bz, toff, eb)}

        def variant_k2(lib):
            def fn():
                out = torch.empty_like(bz)
                call(lib.sprintz_prefix_finish, bz.data_ptr(), toff.data_ptr(),
                     out.data_ptr(), bz.shape[0], bz.shape[1], eb, None, 0, None)
                return out
            return fn
        for k in VARIANTS:
            if k.startswith("K2"):
                k2[k] = variant_k2(libs[k])
        same(f"K2 {key}", dk.prefix_finish_plain(bz, toff, eb), *[f() for f in k2.values()])
        result[f"prefix_finish {key}"] = ab(f"prefix_finish {key}", k2)

        chain = {"earlier": lambda: old_chain(dense, w32, eb),
                 "current": lambda: dk.decode_delta_contiguous(dense, w8, eb)}
        same(f"K1 -> K2 {key}", torch.from_numpy(x[:bz.shape[0]]).to(dev)
             if es == 1 else dk.narrow(torch.from_numpy(x[:bz.shape[0]].astype(np.int32)
                                                        ).to(dev), 16),
             *[f() for f in chain.values()])
        result[f"decode_delta_contiguous {key}"] = ab(f"decode_delta_contiguous {key}", chain)

        k4 = {"earlier": lambda: old_unpack(dense, w32, eb, True),
              "current": lambda: pk.unpack_rows(dense, w8)}
        same(f"K4 {key}", pk.unpack_rows_plain(dense, w8), *[f() for f in k4.values()])
        result[f"unpack_rows {key}"] = ab(f"unpack_rows {key}", k4)
        if es == 1:
            k5 = {"earlier": lambda: old_unpack(dense, w32, eb, True, True),
                  "current": lambda: pk.unpack_rows(dense, w8, narrow=True)}
            same(f"K5 {key}", pk.unpack_rows_plain(dense, w8, True),
                 *[f() for f in k5.values()])
            result[f"unpack_rows_narrow {key}"] = ab(f"unpack_rows_narrow {key}", k5)
        if what == "u8 walk 8 MiB":
            result[f"device pass {key}"] = device_pass(key, dense, w8, eb)
        del dense, w8, w32, bz, toff, plain
    _build.launch = launch
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
