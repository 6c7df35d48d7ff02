#!/usr/bin/env python3
"""The sidecar path's kernels on one CUDA card: check, then time.

    python3 sprintz_tpu_torch/probes/sidecar_probe.py [--reps 25] [--quick]
        [--old DIR] [--device-pass-only] [--root DIR]

1. Builds the kernels, then holds the chunked FIRE decode (on both of its
   kernels, the short-chunk one wherever the chunks fit it) and the chunked
   delta decode (K1 then K2 with chunks, and the lowdim decode with them)
   to their plain versions at ``host_build.FIRE_CASES`` and
   ``SHORT_CASES`` and ``unpack_cases.SEED_CASES`` and ``CHUNK_CASES``
   (the CPU tests' host-build cases), and round-trips
   ``compress_seekable`` / ``decompress(sidecar=)`` / ``decode_range`` on
   small streams of both layouts. ``--quick`` stops there.
2. With ``--old DIR`` (an earlier ``csrc``, for example the parent
   commit's: ``git archive <commit> | tar -x -C build/parent`` and
   ``--old build/parent/sprintz_tpu_torch/csrc``), its
   ``fire.cu`` and ``decode.cu`` are built with the same nvcc flags and
   bound with their own signatures, and the two versions are checked on
   the same inputs, then timed in turns (old, new, new, old; CUDA events, 1
   GiB of L2 flushed before each run, medians of ``--reps``; also the time
   inside the C entry points' launches): the chunked FIRE decode at the 8
   MiB u8 and u16 walks (D 64) and the 4 MiB u8 d4 and u16 d2 walks with a
   checkpoint every 16 groups (chip_smoke.py's streams and seed), and at
   the batch's 512 streams of 256 rows of 64 u8 dims from the zero state;
   the chunked delta decode (new: K1 then K2 with chunks, or the lowdim
   decode with chunks; old: the serial kernels, then the chunk seed's two
   kernels) with each stream's own states and with every chunk moved; and
   the serial K1, K2 and lowdim decode, new and old.
3. The decode's device pass (``decoder.decode_device``) at the 8 MiB u8
   walk and the 4 MiB u8 d4 walk, xff and delta, serial and in the
   sidecar's chunks, in turns on the host's clock to a synchronize (as
   chip_smoke.py's split times it), the chunked pass's enqueue alone,
   ``cProfile`` of 100 chunked passes (the host's time by Python function)
   and one chunked pass under ``torch.profiler``: its ops by host time, and
   the card's time.
   ``--device-pass-only`` runs this alone, and ``--root DIR`` imports the
   port from another checkout (a ``git archive`` of an earlier commit
   under ``build/``), so that one call times the device pass before and
   after a change.

Prints one line a measurement and, last, a JSON line of them all, with
the card's name and power limit. Not imported by the port.
"""

from __future__ import annotations

import argparse
import cProfile
import ctypes
import io
import json
import pathlib
import pstats
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]


def walk_stream(rng, nrows: int, ndims: int, elem_sz: int) -> np.ndarray:
    """chip_smoke.py's walk: steps in [-6, 6]."""
    hi = 1 << (8 * elem_sz)
    return (np.cumsum(rng.integers(-6, 7, (nrows, ndims)), axis=0) % hi
            ).astype(np.uint8 if elem_sz == 1 else np.uint16)


# Variants of the current fire.cu's short-chunk decode: (what it changes,
# [(text, replacement)]), timed beside it with --variants
VARIANTS = {
    "as committed": [],
    "4 units a thread in flight": [
        ("constexpr int STAGE_DEPTH = 8;", "constexpr int STAGE_DEPTH = 4;")],
    "64 lanes a CTA (fewer CTAs where D < 32)": [
        ("constexpr int SHORT_LANES = 32;", "constexpr int SHORT_LANES = 64;")],
    "rows addressed by running sums": [
        ("      for (int r = 0; r < BLOCK_SZ; ++r) e[r] = q[row_off[r]];",
         "      for (int r = 0; r < BLOCK_SZ; ++r) e[r] = q[r * step];"),
        ("        q[row_off[r]] = (T)val;", "        q[r * step] = (T)val;")],
    "sign by two compares": [
        ("          const int32_t m = err == 0 ? 0 : (err < 0 ? (int32_t)0xffff0000u : 0x00010000);\n"
         "          grad_sum = F::advance(word, m, grad_sum);\n        }\n        word = F::advance(word, cm, r == 0",
         "          const int32_t m = (int32_t)(((uint32_t)(err > 0) - (uint32_t)(err < 0)) << 16);\n"
         "          grad_sum = F::advance(word, m, grad_sum);\n        }\n        word = F::advance(word, cm, r == 0")],
    "128 threads a CTA": [
        ("constexpr int SHORT_THREADS = 256;", "constexpr int SHORT_THREADS = 128;"),
        ("constexpr int SHORT_MAX_DIMS = 256;", "constexpr int SHORT_MAX_DIMS = 128;")],
    # ablations (wrong values, timed only): the stage and store alone
    "ablation: no chain": [
        ("  if (tid < nc * ndims) {\n    const int cl = tid / ndims, d = tid - cl * ndims;",
         "  if (false) {\n    const int cl = tid / ndims, d = tid - cl * ndims;")],
}
# clock64 counters of the short kernel's phases, by thread 0 of each CTA
# (chunk starts and unit scan, stage, chain, store), its CTAs, and the span
# of the launch by the card's global timer
PHASES = ("bounds and scan", "stage", "chain", "store")
PHASE_HELPERS = r"""
__device__ unsigned long long g_phase[8];
#define PHASE(k)                                              \
  if (threadIdx.x == 0) {                                     \
    const unsigned long long t_ = clock64();                  \
    atomicAdd(&g_phase[k], t_ - t_phase);                     \
    t_phase = t_;                                             \
  }
"""
PHASE_ENTRY = r"""
extern "C" int sprintz_phase_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
}
extern "C" int sprintz_phase_zero() {
  unsigned long long init[8] = {0, 0, 0, 0, 0, ~0ull, 0, 0};
  return (int)cudaMemcpyToSymbol(g_phase, init, sizeof(init));
}
"""
PHASE_EDITS = [
    ("// ---- end of PTX\n", "// ---- end of PTX\n" + PHASE_HELPERS),
    ("  long long* s_e0 = reinterpret_cast<long long*>(fire_smem + cpc * slot);  // [nc + 1]\n",
     "  unsigned long long t_phase = clock64();\n  const unsigned long long ns0 = global_ns();\n"
     "  long long* s_e0 = reinterpret_cast<long long*>(fire_smem + cpc * slot);  // [nc + 1]\n"),
    ("  __syncthreads();\n  const int nunits = s_units[nc];\n",
     "  __syncthreads();\n  PHASE(0);\n  const int nunits = s_units[nc];\n"),
    ("  __syncthreads();\n\n  // 2. Chain:", "  __syncthreads();\n  PHASE(1);\n\n  // 2. Chain:"),
    ("  __syncthreads();\n\n  // 3. Store:", "  __syncthreads();\n  PHASE(2);\n\n  // 3. Store:"),
    ("        if (g + k >= lo && g + k < hi) out8[g + k] = img[k];\n      }\n    }\n  }\n}\n",
     "        if (g + k >= lo && g + k < hi) out8[g + k] = img[k];\n      }\n    }\n  }\n"
     "  __syncthreads();\n  PHASE(3);\n  if (threadIdx.x == 0) {\n"
     "    atomicMin(&g_phase[5], ns0);\n    atomicMax(&g_phase[6], global_ns());\n"
     "    atomicAdd(&g_phase[7], 1ull);\n  }\n}\n"),
    ('}  // extern "C"\n', '}  // extern "C"\n' + PHASE_ENTRY),
]

# the streams of the timings: (what, rows, dims, element bytes)
STREAMS = (("u8 walk 8 MiB", 1 << 17, 64, 1), ("u16 walk 8 MiB", 1 << 16, 64, 2),
           ("u8 d4 walk 4 MiB", 1 << 20, 4, 1), ("u16 d2 walk 4 MiB", 1 << 20, 2, 2))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--old", type=pathlib.Path, help="an earlier csrc directory")
    ap.add_argument("--variants", action="store_true",
                    help="with --old: the short kernel's VARIANTS and phase counters too")
    ap.add_argument("--device-pass-only", action="store_true")
    ap.add_argument("--root", type=pathlib.Path, default=ROOT,
                    help="the checkout whose sprintz_tpu_torch to import")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    from sprintz_tpu_torch import SprintzCodec, checkpoint, decoder
    from sprintz_tpu_torch.models import forecasters as fc
    from sprintz_tpu_torch.ops import _build
    from sprintz_tpu_torch.ops import decode_kernels as dk
    from sprintz_tpu_torch.stream_format import read_metadata_rle

    if not torch.cuda.is_available():
        print("sidecar_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60
                         ).stdout.strip().splitlines()[0]
    print(f"card: {smi} (the port from {args.root})", flush=True)
    for p in _build.build().values():
        if p.stem.startswith(("libfire", "libdecode")) and not args.device_pass_only:
            print(p.with_suffix(".log").read_text(), file=sys.stderr)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    out = {"card": smi, "reps": args.reps, "root": str(args.root)}

    def same(name, got, want):
        torch.cuda.synchronize()
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if g.dtype != w.dtype or not torch.equal(g.cpu(), w.cpu()):
                raise AssertionError(f"{name} differs from its plain version")

    def host_ms(fn) -> float:
        torch.cuda.synchronize()
        c = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - c) * 1e3

    def device_pass():
        """The decode's device pass, serial and in the sidecar's chunks, at
        the 8 MiB u8 walk and the 4 MiB u8 d4 walk, xff and delta."""
        from torch.profiler import ProfilerActivity, profile

        srng = np.random.default_rng(0)
        res = {}
        for what, nrows, nd, es in (STREAMS[0], STREAMS[2]):
            x = walk_stream(srng, nrows, nd, es)
            for codec in ("xff", "delta"):
                buf, sc = checkpoint.compress_with_sidecar(x.reshape(-1), nd, codec,
                                                           device=dev)
                ng, _, _ = read_metadata_rle(buf)
                lowdim = nd <= 4 // es
                idx = decoder.walk_headers(buf, ng, nd, es, lowdim)
                up = decoder.upload_payload(decoder.gather_payloads(buf, idx), idx, dev)
                states = np.zeros((sc.states.shape[0], 3, nd), np.int32)
                states[:, : sc.states.shape[1]] = sc.states
                chunks = (sc.row_offsets // 8, states)
                fns = {"serial": lambda: decoder.decode_device(
                           *up, idx.total_rows, es, codec, lowdim),
                       "chunks": lambda: decoder.decode_device(
                           *up, idx.total_rows, es, codec, lowdim, chunks=chunks)}
                if not np.array_equal(decoder.download_values(fns["chunks"]()),
                                      x.reshape(-1)[: idx.total_rows * nd]):
                    raise AssertionError(f"{what} {codec}: the chunked decode differs")
                times = {k: [] for k in fns}
                for fn in fns.values():
                    fn()
                for _ in range(args.reps):
                    for k in ("serial", "chunks", "chunks", "serial"):
                        times[k].append(host_ms(fns[k]))
                r = {k: statistics.median(v) for k, v in times.items()}
                # the host's part: the chunked pass's enqueue alone, and a
                # profile of its Python by function
                enq = []
                for _ in range(args.reps):
                    torch.cuda.synchronize()
                    c = time.perf_counter()
                    fns["chunks"]()
                    enq.append((time.perf_counter() - c) * 1e3)
                r["chunks_enqueue"] = statistics.median(enq)
                torch.cuda.synchronize()
                pr = cProfile.Profile()
                pr.enable()
                for _ in range(100):
                    fns["chunks"]()
                    torch.cuda.synchronize()
                pr.disable()
                top = io.StringIO()
                pstats.Stats(pr, stream=top).sort_stats("tottime").print_stats(12)
                print(f"[device pass] {what} {codec}, chunks, cProfile of 100 passes "
                      f"(each to a synchronize):\n" + "\n".join(
                          top.getvalue().splitlines()[:30]), flush=True)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    fns["chunks"]()
                    torch.cuda.synchronize()
                ka = prof.key_averages()
                r["chunks_profiler_cuda_ms"] = sum(
                    getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                    for e in ka) / 1e3
                res[f"{what} {codec}"] = r
                print(f"[device pass] {what} {codec}: host clock to a synchronize, "
                      f"serial {r['serial']:.4f} ms, chunks {r['chunks']:.4f} ms "
                      f"(enqueue {r['chunks_enqueue']:.4f} ms); "
                      f"the chunked pass's device time by torch.profiler "
                      f"{r['chunks_profiler_cuda_ms']:.4f} ms\n"
                      + ka.table(sort_by="self_cpu_time_total", row_limit=14),
                      flush=True)
        return res

    if args.device_pass_only:
        out["device_pass_ms"] = device_pass()
        return finish(out)

    from sprintz_tpu_torch.probes import host_build as hb
    from sprintz_tpu_torch.probes import unpack_cases as uc

    # ------------------------------------------------------------ checks
    def launch_ring(zz, eb, first, states, trunc):
        """The chunked decode on the ring kernel, whatever the chunks."""
        n, nd = zz.shape
        vals = torch.empty((n, nd), dtype=dk.narrow_dtype(eb), device=dev)
        f = torch.from_numpy(np.asarray(first, dtype=np.int64)).to(dev)
        st = states.to(dev, torch.int32).contiguous()
        _build.launch("sprintz_fire_decode_chunks", zz, zz.data_ptr(), st.data_ptr(),
                      f.data_ptr(), f.numel() - 1, vals.data_ptr(), n // 8, nd, eb,
                      int(trunc))
        return vals

    fire_cases = [(e, d, b, c, t) for e, d, b, c, t in hb.FIRE_CASES] + hb.SHORT_CASES
    for eb, nd, nb, chunks, trunc in fire_cases:
        zz, first, states = hb.short_case(eb, nd, nb, chunks, trunc)
        zz, states = zz.to(dev), states.to(dev)
        want = fc.fire_decode_chunks_plain(zz, eb, first, states, trunc)
        same(f"fire_decode_chunks {(eb, nd, nb, chunks, trunc)}",
             fc.fire_decode_chunks(zz, eb, first, states, trunc), want)
        same(f"ring kernel {(eb, nd, nb, chunks, trunc)}",
             launch_ring(zz, eb, first, states, trunc), want)
    cuts = [(eb, nd, nb, hb.chunk_cuts(np.random.default_rng(nb), nb, c))
            for eb, nd, nb, c in uc.SEED_CASES]
    cuts += [(eb, nd, nb, np.asarray(f)) for _, eb, nd, nb, f in uc.CHUNK_CASES]
    for eb, nd, nb, first in cuts:
        rng = np.random.default_rng(eb + nd + nb)
        st = rng.integers(-999, 999, (first.size - 1, nd)).astype(np.int32)
        ck = dk.delta_chunks(first, st, nb, nd, dev)
        dense, widths, _ = uc.unpack_case(rng, eb, nd, nb, "random")
        d, w = uc.to_device(dense, widths, "random", dev)
        bz, toff = dk.unpack_zz_plain(d, w, eb, ck)
        same(f"chunked K1 then K2 {(eb, nd, nb)}", dk.decode_delta_contiguous(d, w, eb, ck),
             dk.prefix_finish_plain(bz.reshape(-1, nd), toff, eb, ck))
        if nd * eb <= 32:
            dense, widths, _ = uc.lowdim_case(rng, eb, nd, nb, "random")
            d, w = uc.to_device(dense, widths, "random", dev)
            same(f"chunked lowdim decode {(eb, nd, nb)}",
                 dk.decode_delta_lowdim(d, w, eb, ck),
                 dk.decode_delta_lowdim_plain(d, w, eb, ck))
    rng = np.random.default_rng(1)
    for codec in ("delta", "xff"):
        for nd, es in ((9, 1), (3, 2), (4, 1), (64, 2)):
            x = walk_stream(rng, 4096, nd, es)
            cd = SprintzCodec(codec, es, device="cuda")
            buf, sc = cd.compress_seekable(x)
            if buf != cd.compress(x) or not np.array_equal(
                    cd.decompress(buf, sidecar=sc), x.reshape(-1)):
                raise AssertionError(f"seekable {codec} D {nd} u{8 * es}")
            if not np.array_equal(checkpoint.decode_range(
                    buf, sc, 1000, 900, device="cuda"), x[1000:1900]):
                raise AssertionError(f"decode_range {codec} D {nd}")
    print(f"[check] {len(fire_cases)} FIRE cases (both chunked kernels), "
          f"{len(cuts)} chunked delta cases and 8 seekable round trips on the "
          f"card: exact", flush=True)
    if args.quick:
        return 0

    # ------------------------------------------------------- old vs new
    if args.old is not None:
        out["ab"] = old_new(args, torch, dev, flush, same)
    out["device_pass_ms"] = device_pass()
    return finish(out)


def finish(out: dict) -> int:
    print(json.dumps(out), flush=True)
    return 0


def old_new(args, torch, dev, flush, same) -> dict:
    """The earlier csrc's chunked FIRE decode, serial delta decode and chunk
    seed against the current kernels, on the same inputs, in turns."""
    from sprintz_tpu_torch import checkpoint
    from sprintz_tpu_torch.models import forecasters as fc
    from sprintz_tpu_torch.ops import _build
    from sprintz_tpu_torch.ops import decode_kernels as dk

    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for stem in ("fire", "decode"):  # the compiler's report beside each library
        lib = _build.BUILD_DIR / "old" / f"lib{stem}_old.so"
        lib.parent.mkdir(parents=True, exist_ok=True)
        with open(lib.with_suffix(".log"), "wb") as log:
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                            str(args.old / f"{stem}.cu")], check=True, stdout=log,
                           stderr=subprocess.STDOUT)
        print(f"[old build] {stem}.cu:\n" + lib.with_suffix(".log").read_text(),
              file=sys.stderr, flush=True)
        libs[stem] = ctypes.CDLL(str(lib))
    sig = {("fire", "sprintz_fire_decode_chunks"): [P, P, P, I, L, P, L, I, I, I, P],
           ("decode", "sprintz_unpack_zz"): [P, P, P, P, P, L, I, I, I, I, P],
           ("decode", "sprintz_prefix_finish"): [P, P, P, L, I, I, P],
           ("decode", "sprintz_decode_lowdim"): [P, P, P, P, L, I, I, I, P],
           ("decode", "sprintz_delta_chunk_seed"): [P, P, P, P, I, L, I, I, P]}
    events = []  # (start, end) of the launches of a timed run

    def call(stem, name, *a):
        fn = getattr(libs[stem], name)
        fn.argtypes, fn.restype = sig[stem, name], ctypes.c_int
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        err = fn(*a, torch.cuda.current_stream().cuda_stream)
        e.record()
        events.append((s, e))
        if err:
            raise RuntimeError(f"old {name}: CUDA error {err}")

    def current(fn):
        """fn with each current launch between events too."""
        def run():
            launch = _build.launch

            def timed(name, like, *a):
                s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                s.record()
                launch(name, like, *a)
                e.record()
                events.append((s, e))
            _build.launch = timed
            try:
                return fn()
            finally:
                _build.launch = launch
        return run

    def run_ms(fn) -> tuple[float, float]:
        flush.zero_()
        events.clear()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e), sum(a.elapsed_time(b) for a, b in events)

    def turns(fns: dict) -> dict:
        """{name: fn} in turns (each order and its reverse), after a warm-up:
        medians of the wrapper's time and of the time inside its launches."""
        for fn in fns.values():
            fn()
        t = {k: [] for k in fns}
        t.update({k + " (launches)": [] for k in fns})
        names = list(fns)
        for _ in range(args.reps):
            for k in names + names[::-1]:
                a, b = run_ms(fns[k])
                t[k].append(a)
                t[k + " (launches)"].append(b)
        return {k: statistics.median(v) for k, v in t.items()}

    def old_fire(zz, eb, first, most, states, trunc):
        n, nd = zz.shape
        vals = torch.empty((n, nd), dtype=dk.narrow_dtype(eb), device=dev)
        call("fire", "sprintz_fire_decode_chunks", zz.data_ptr(), states.data_ptr(),
             first.data_ptr(), first.numel() - 1, most, vals.data_ptr(), n // 8, nd, eb,
             int(trunc))
        return vals

    res = {}
    srng = np.random.default_rng(0)
    fire_shapes = []
    for what, nrows, nd, es in STREAMS:
        x = walk_stream(srng, nrows, nd, es)
        eb, trunc = 8 * es, nd > 4 // es
        rows = torch.from_numpy(x.astype(np.int32)).to(dev)
        errs = fc.fire_encode(rows, eb, trunc)
        zz = errs.to(torch.uint8) if eb == 8 else errs
        _, sc = checkpoint.compress_with_sidecar(x.reshape(-1), nd, "xff", device=dev)
        first = np.append(sc.row_offsets // 8, nrows // 8)
        fire_shapes.append((what, zz, eb, first, torch.from_numpy(sc.states), trunc, rows))
    # the batch's 512 streams of 256 rows x 64 u8 dims, each from the zero state
    bx = walk_stream(srng, 512 * 256, 64, 1).reshape(512, 256, 64)
    lanes = torch.from_numpy(bx.transpose(1, 0, 2).reshape(256, -1).astype(np.int32)).to(dev)
    berrs = fc.fire_encode(lanes, 8).reshape(256, 512, 64).permute(1, 0, 2).reshape(
        -1, 64).to(torch.uint8).contiguous()
    fire_shapes.append(("batch u8 512 x 256 x 64", berrs, 8, np.arange(513) * 32,
                        torch.zeros((512, 3, 64), dtype=torch.int32), True,
                        torch.from_numpy(bx.reshape(-1, 64).astype(np.int32)).to(dev)))
    for what, zz, eb, first, states, trunc, rows in fire_shapes:
        st = states.to(dev).contiguous()  # a sidecar's states may be a strided view
        fd = torch.from_numpy(first.astype(np.int64)).to(dev)
        most = int(np.diff(first).max())
        new = fc.fire_decode_chunks(zz, eb, first, st, trunc)
        if not torch.equal(dk.widen(new), rows):
            raise AssertionError(f"{what}: the chunked FIRE decode differs")
        same(f"{what}: old chunked FIRE decode", old_fire(zz, eb, fd, most, st, trunc), new)
        r = turns({"old": lambda: old_fire(zz, eb, fd, most, st, trunc),
                   "new": current(lambda: fc.fire_decode_chunks(zz, eb, first, st,
                                                                trunc))})
        r["chunks"] = int(first.size - 1)
        res[f"FIRE chunks {what}"] = r
        print(f"[ab] FIRE chunked decode {what}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in r.items()), flush=True)

    if args.variants:
        res.update(short_variants(args, torch, dev, run_ms, turns, same, fire_shapes, current))

    # the delta decode: serial, and chunked at the sidecar's chunks
    srng = np.random.default_rng(0)
    for what, nrows, nd, es in STREAMS:
        from sprintz_tpu_torch import decoder
        from sprintz_tpu_torch.stream_format import read_metadata_rle

        x = walk_stream(srng, nrows, nd, es)
        eb, lowdim = 8 * es, nd <= 4 // es
        buf, sc = checkpoint.compress_with_sidecar(x.reshape(-1), nd, "delta", device=dev)
        idx = decoder.walk_headers(buf, read_metadata_rle(buf)[0], nd, es, lowdim)
        dense, dw, _ = decoder.upload_payload(decoder.gather_payloads(buf, idx), idx, dev)
        nb = dense.shape[0]
        first = np.append(sc.row_offsets // 8, nb)
        st = torch.from_numpy(sc.states[:, 0]).to(dev).contiguous()
        every = st + 1  # every chunk moves
        ck, ck_every = (dk.delta_chunks(first, s, nb, nd, dev) for s in (st, every))
        rows_d = torch.from_numpy(first * 8).to(dev)
        ntiles = -(-nb // 32)
        status_old = torch.zeros(nb + 2, dtype=torch.int64, device=dev)

        def old_serial():
            if lowdim:
                vals = torch.empty((nb * 8, nd), dtype=dk.narrow_dtype(eb), device=dev)
                call("decode", "sprintz_decode_lowdim", dense.data_ptr(), dw.data_ptr(),
                     vals.data_ptr(), status_old.data_ptr(), nb, nd, eb, 0)
                return vals
            bz = torch.empty((nb, 8, nd), dtype=dk.narrow_dtype(eb), device=dev)
            toff = torch.empty((ntiles, 1, nd), dtype=torch.int32, device=dev)
            status = torch.empty(ntiles * nd + 1, dtype=torch.int64, device=dev)
            call("decode", "sprintz_unpack_zz", dense.data_ptr(), dw.data_ptr(),
                 bz.data_ptr(), toff.data_ptr(), status.data_ptr(), nb, nd,
                 dense.shape[2], eb, 0)
            vals = torch.empty((nb * 8, nd), dtype=bz.dtype, device=dev)
            call("decode", "sprintz_prefix_finish", bz.data_ptr(), toff.data_ptr(),
                 vals.data_ptr(), nb * 8, nd, eb)
            return vals

        def old_chunked(states):
            vals = old_serial()
            scratch = torch.empty(states.shape[0] * (nd + 1), dtype=torch.int32,
                                  device=dev)
            call("decode", "sprintz_delta_chunk_seed", vals.data_ptr(), rows_d.data_ptr(),
                 states.data_ptr(), scratch.data_ptr(), states.shape[0],
                 int(np.diff(first).max()) * 8, nd, eb)
            return vals

        def new_serial():
            return (dk.decode_delta_lowdim(dense, dw, eb) if lowdim
                    else dk.decode_delta_contiguous(dense, dw, eb))

        def new_chunked(c):
            return (dk.decode_delta_lowdim(dense, dw, eb, c) if lowdim
                    else dk.decode_delta_contiguous(dense, dw, eb, c))

        same(f"{what}: old serial delta decode", old_serial(), new_serial())
        for c, s_ in ((ck, st), (ck_every, every)):
            same(f"{what}: old chunked delta decode", old_chunked(s_), new_chunked(c))
        r = turns({"old serial": old_serial, "new serial": current(new_serial)})
        r.update(turns({"old serial + seed": lambda: old_chunked(st),
                        "new chunked": current(lambda: new_chunked(ck))}))
        r.update(turns({"old serial + seed, every chunk moved": lambda: old_chunked(every),
                        "new chunked, every chunk moved":
                            current(lambda: new_chunked(ck_every))}))
        if not lowdim:  # K2 alone, on K1's output, new and old
            bz, toff = dk.unpack_zz(dense, dw, eb)
            bz = bz.reshape(-1, nd)

            def old_k2():
                vals = torch.empty_like(bz)
                call("decode", "sprintz_prefix_finish", bz.data_ptr(), toff.data_ptr(),
                     vals.data_ptr(), nb * 8, nd, eb)

            def old_k1():
                b = torch.empty((nb, 8, nd), dtype=bz.dtype, device=dev)
                t = torch.empty((ntiles, 1, nd), dtype=torch.int32, device=dev)
                status = torch.empty(ntiles * nd + 1, dtype=torch.int64, device=dev)
                call("decode", "sprintz_unpack_zz", dense.data_ptr(), dw.data_ptr(),
                     b.data_ptr(), t.data_ptr(), status.data_ptr(), nb, nd,
                     dense.shape[2], eb, 0)
            r.update(turns({"old K1": old_k1,
                            "new K1": current(lambda: dk.unpack_zz(dense, dw, eb))}))
            r.update(turns({"old K2": old_k2,
                            "new K2": current(lambda: dk.prefix_finish(bz, toff, eb))}))
        r["chunks"] = int(first.size - 1)
        res[f"delta {what}"] = r
        print(f"[ab] delta decode {what}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in r.items()), flush=True)
    return res


def short_variants(args, torch, dev, run_ms, turns, same, fire_shapes, current) -> dict:
    """The short-chunk decode beside its VARIANTS (each built from the
    current fire.cu with its edits) at the FIRE A/B shapes, in turns, and
    its phases by clock64 counters (a variant with PHASE_EDITS)."""
    from sprintz_tpu_torch.models import forecasters as fc
    from sprintz_tpu_torch.ops import _build
    from sprintz_tpu_torch.ops import decode_kernels as dk

    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    src = (ROOT / "sprintz_tpu_torch" / "csrc" / "fire.cu").read_text()
    builds = dict(VARIANTS)
    builds["phase counters"] = PHASE_EDITS
    libs = {}
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, edits in builds.items():
        text = src
        for a, b in edits:
            assert text.count(a) == 1, (name, a)
            text = text.replace(a, b)
        slug = "".join(c if c.isalnum() else "_" for c in name)
        cu, so = out_dir / f"fire_{slug}.cu", out_dir / f"libfire_{slug}.so"
        cu.write_text(text)
        procs.append((name, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)))
    for name, so, proc in procs:
        if proc.wait():
            raise RuntimeError(f"nvcc failed on the variant {name}")
        lib = ctypes.CDLL(str(so))
        fn = lib.sprintz_fire_decode_short
        fn.argtypes, fn.restype = [P, P, P, I, L, P, L, I, I, I, P], ctypes.c_int
        libs[name] = lib
    counters = libs["phase counters"]
    counters.sprintz_phase_read.argtypes = [P]

    def short_on(lib, zz, eb, fd, nchunks, most, st, trunc):
        n, nd = zz.shape
        vals = torch.empty((n, nd), dtype=dk.narrow_dtype(eb), device=dev)
        err = lib.sprintz_fire_decode_short(
            zz.data_ptr(), st.data_ptr(), fd.data_ptr(), nchunks, most, vals.data_ptr(),
            n // 8, nd, eb, int(trunc), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant: CUDA error {err}")
        return vals

    res = {}
    for what, zz, eb, first, states, trunc, rows in fire_shapes:
        st = states.to(dev).contiguous()
        fd = torch.from_numpy(first.astype(np.int64)).to(dev)
        most, nchunks = int(np.diff(first).max()), int(first.size - 1)
        want = fc.fire_decode_chunks(zz, eb, first, st, trunc)
        fns = {"current": current(lambda: fc.fire_decode_chunks(zz, eb, first, st, trunc))}
        for name, lib in libs.items():
            if name == "phase counters":
                continue
            if not fc.fire_short_fits(most, zz.shape[1], eb):
                continue
            if not name.startswith("ablation"):
                same(f"{what}: variant {name}", short_on(lib, zz, eb, fd, nchunks, most, st,
                                                          trunc), want)
            fns[name] = (lambda lib=lib: short_on(lib, zz, eb, fd, nchunks, most, st, trunc))
        r = turns(fns)
        # phases: one launch after a flush, counters read after it
        same(f"{what}: phase counters", short_on(counters, zz, eb, fd, nchunks, most, st,
                                                 trunc), want)
        cyc = np.zeros(8, dtype=np.uint64)
        for _ in range(3):
            counters.sprintz_phase_zero()
            run_ms(lambda: short_on(counters, zz, eb, fd, nchunks, most, st, trunc))
            torch.cuda.synchronize()
            counters.sprintz_phase_read(cyc.ctypes.data)
        ctas = max(int(cyc[7]), 1)
        r["phases (cycles a CTA)"] = {k: float(cyc[i]) / ctas for i, k in enumerate(PHASES)}
        r["ctas"] = ctas
        r["span_ns"] = float(cyc[6] - cyc[5])
        res[f"short variants {what}"] = r
        print(f"[variants] FIRE short decode {what}: " + json.dumps(r), flush=True)
    return res


if __name__ == "__main__":
    sys.exit(main())
