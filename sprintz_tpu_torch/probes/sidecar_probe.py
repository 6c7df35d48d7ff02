#!/usr/bin/env python3
"""The sidecar path's kernels on one CUDA card: check, then time.

    python3 sprintz_tpu_torch/probes/sidecar_probe.py [--reps 25] [--quick]
        [--variant FILE ...]

1. Builds the kernels, then holds FIRE's encode with its states, the
   chunked FIRE decode and the delta chunk seed to their plain versions
   at ``host_build.FIRE_CASES`` and ``unpack_cases.SEED_CASES`` (the CPU
   tests' host-build cases), and round-trips ``compress_seekable`` /
   ``decompress(sidecar=)`` on small streams of both layouts.
2. Unless ``--quick``: at the 8 MiB u8 and u16 walks (D 64) and the 4 MiB
   u8 d4 and u16 d2 walks (chip_smoke.py's streams and seed), with a
   checkpoint every 16 groups, times in turns (serial, chunked, chunked,
   serial; CUDA events, 1 GiB of L2 flushed before each run, medians):
   the chunked FIRE decode beside the serial one, the encode with its
   states beside the encode without, and the delta chunk seed with the
   stream's own states (nothing moves) and with every chunk moved.
   Each ``--variant`` (another fire.cu, kept under ``build/``, which git
   ignores) is built with the same nvcc flags, checked at the FIRE cases,
   and its chunked decode and states' encode join the turns; with
   ``--ablate`` the variants are ablations (work taken out), timed and
   not checked.
3. Unless ``--quick``: the xff decode's device pass
   (``decoder.decode_device``) serial and in the sidecar's chunks, in
   turns on the host's clock to a synchronize (as chip_smoke.py's split
   times it), and one run of each under ``torch.profiler``: its ops by
   host time, and the card's time.

Prints one line a measurement and a JSON line of them all, with the
card's name and power limit. Not imported by the port.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]


def walk_stream(rng, nrows: int, ndims: int, elem_sz: int) -> np.ndarray:
    """chip_smoke.py's walk: steps in [-6, 6]."""
    hi = 1 << (8 * elem_sz)
    return (np.cumsum(rng.integers(-6, 7, (nrows, ndims)), axis=0) % hi
            ).astype(np.uint8 if elem_sz == 1 else np.uint16)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--variant", type=pathlib.Path, nargs="*", default=[])
    ap.add_argument("--ablate", action="store_true",
                    help="variants with work taken out: timed, not checked")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from sprintz_tpu_torch import SprintzCodec, checkpoint
    from sprintz_tpu_torch.models import forecasters as fc
    from sprintz_tpu_torch.ops import _build
    from sprintz_tpu_torch.ops import decode_kernels as dk
    from sprintz_tpu_torch.probes import host_build as hb
    from sprintz_tpu_torch.probes import unpack_cases as uc

    if not torch.cuda.is_available():
        print("sidecar_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60
                         ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    for p in _build.build().values():
        if p.stem.startswith(("libfire", "libdecode")):
            print(p.with_suffix(".log").read_text(), file=sys.stderr)

    def variant(src: pathlib.Path):
        """src built as the committed fire.cu is, bound as _build binds it."""
        import ctypes
        import hashlib

        key = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
        lib = _build.BUILD_DIR / "variants" / f"lib{src.stem}_{key}.so"
        lib.parent.mkdir(parents=True, exist_ok=True)
        if not lib.exists():
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                            str(src)], check=True)
        so = ctypes.CDLL(str(lib))
        for name, (stem, argtypes) in _build.SIGNATURES.items():
            if stem == "fire":
                getattr(so, name).argtypes = list(argtypes)
                getattr(so, name).restype = ctypes.c_int
        return so

    def on(so, fn):
        """fn with the FIRE entry points taken from library so."""
        def run():
            launch = _build.launch

            def routed(name, like, *a):
                if _build.SIGNATURES[name][0] != "fire":
                    return launch(name, like, *a)
                with torch.cuda.device(like.device):
                    err = getattr(so, name)(
                        *a, torch.cuda.current_stream(like.device).cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            _build.launch = routed
            try:
                return fn()
            finally:
                _build.launch = launch
        return run

    variants = {v.name: variant(v) for v in args.variant}

    def same(name, got, want):
        torch.cuda.synchronize()
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if g.dtype != w.dtype or not torch.equal(g.cpu(), w.cpu()):
                raise AssertionError(f"{name} differs from its plain version")

    # ------------------------------------------------------------ checks
    for eb, nd, nb, nchunks, trunc in hb.FIRE_CASES:
        rng = np.random.default_rng(eb * 7919 + nd * 31 + nb * 3 + nchunks)
        rows = torch.from_numpy(walk_stream(rng, nb * 8, nd, eb // 8).astype(
            np.int32)).to(dev)
        got = fc.fire_encode(rows, eb, trunc, states=True)
        same(f"fire_encode_states case {(eb, nd, nb, trunc)}", got,
             fc.fire_encode_plain(rows, eb, trunc, states=True))
        zz = got[0].to(torch.uint8) if eb == 8 else got[0]
        first = hb.chunk_cuts(rng, nb, nchunks)
        half = 1 << (eb - 1)
        states = torch.from_numpy(np.stack([
            rng.integers(0, 2 * half, (nchunks, nd)),
            rng.integers(-(1 << 20), 1 << 20, (nchunks, nd)),
            rng.integers(-(1 << 15), 1 << 15, (nchunks, nd))], axis=1
        ).astype(np.int32))
        want = fc.fire_decode_chunks_plain(zz, eb, first, states, trunc)
        same(f"fire_decode_chunks case {(eb, nd, nb, nchunks, trunc)}",
             fc.fire_decode_chunks(zz, eb, first, states, trunc), want)
        for vname, so in ({} if args.ablate else variants).items():
            same(f"{vname} fire_decode_chunks case", on(so, lambda: (
                fc.fire_decode_chunks(zz, eb, first, states, trunc)))(), want)
            same(f"{vname} fire_encode_states case", on(so, lambda: (
                fc.fire_encode(rows, eb, trunc, states=True)))(),
                fc.fire_encode_plain(rows, eb, trunc, states=True))
    for eb, nd, nb, nchunks in uc.SEED_CASES:
        rng = np.random.default_rng(eb * 13 + nd * 7 + nb + nchunks)
        vals = dk.narrow(torch.from_numpy(rng.integers(
            0, 1 << eb, (nb * 8, nd)).astype(np.int32)), eb).to(dev)
        rows = hb.chunk_cuts(rng, nb, nchunks) * 8
        st = torch.from_numpy(rng.integers(-999, 999, (nchunks, nd)).astype(
            np.int32))
        same(f"delta_chunk_seed case {(eb, nd, nb, nchunks)}",
             dk.delta_chunk_seed(vals.clone(), rows, st, eb),
             dk.delta_chunk_seed_plain(vals, rows, st, eb))
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
    print(f"[check] {len(hb.FIRE_CASES)} FIRE cases, {len(uc.SEED_CASES)} "
          f"seed cases and 8 seekable round trips on the card: exact",
          flush=True)
    if args.quick:
        return 0

    # ------------------------------------------------------------ timing
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)

    def run_ms(fn) -> float:
        flush.zero_()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    def launch_ms(fn) -> float:
        """The card time inside fn's kernel launches alone: events just
        before and after each C entry point."""
        flush.zero_()
        events, launch = [], _build.launch

        def timed(name, like, *a):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            launch(name, like, *a)
            e.record()
            events.append((s, e))

        _build.launch = timed
        try:
            fn()
        finally:
            _build.launch = launch
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events)

    def turns(fns: dict) -> dict:
        """Each fn twice a round, in turns (a, b, b, a), after a warm-up:
        the wrapper's time, and the time inside its launches ("_launch")."""
        for fn in fns.values():
            fn()
        times = {k: [] for k in fns}
        times.update({k + "_launch": [] for k in fns})
        names = list(fns)
        for _ in range(args.reps):
            for k in names + names[::-1]:
                times[k].append(run_ms(fns[k]))
                times[k + "_launch"].append(launch_ms(fns[k]))
        return {k: statistics.median(v) for k, v in times.items()}

    out = {}
    srng = np.random.default_rng(0)
    for what, nrows, nd, es in (("u8 walk 8 MiB", 1 << 17, 64, 1),
                                ("u16 walk 8 MiB", 1 << 16, 64, 2),
                                ("u8 d4 walk 4 MiB", 1 << 20, 4, 1),
                                ("u16 d2 walk 4 MiB", 1 << 20, 2, 2)):
        x = walk_stream(srng, nrows, nd, es)
        eb, trunc = 8 * es, nd > 4 // es
        rows = torch.from_numpy(x.astype(np.int32)).to(dev)
        errs = fc.fire_encode(rows, eb, trunc)
        zz = errs.to(torch.uint8) if eb == 8 else errs
        _, sc = checkpoint.compress_with_sidecar(x.reshape(-1), nd, "xff",
                                                 device=dev)
        first = np.append(sc.row_offsets // 8, nrows // 8)
        st = torch.from_numpy(sc.states).to(dev)
        if not torch.equal(dk.widen(fc.fire_decode_chunks(
                zz, eb, first, st, trunc)), rows):
            raise AssertionError(f"{what}: the chunked decode differs")
        r = {"chunks": int(first.size - 1),
             "blocks_per_chunk": int(np.diff(first).max())}
        dec = {"fire_decode": lambda: fc.fire_decode(zz, eb, None, trunc),
               "fire_decode_chunks": lambda: fc.fire_decode_chunks(
                   zz, eb, first, st, trunc)}
        enc = {"fire_encode": lambda: fc.fire_encode(rows, eb, trunc),
               "fire_encode_states": lambda: fc.fire_encode(rows, eb, trunc,
                                                            states=True)}
        for vname, so in variants.items():
            dec[f"{vname} fire_decode_chunks"] = on(so, dec["fire_decode_chunks"])
            enc[f"{vname} fire_encode_states"] = on(so, enc["fire_encode_states"])
        r.update(turns(dec))
        r.update(turns(enc))
        vals = dk.narrow(rows, eb)
        _, dsc = checkpoint.compress_with_sidecar(x.reshape(-1), nd, "delta",
                                                  device=dev)
        drows = np.append(dsc.row_offsets, nrows)
        dst = torch.from_numpy(dsc.states[:, 0]).to(dev)
        every = dst + 1
        scratch = vals.clone()
        r.update(turns({
            "delta_chunk_seed": lambda: dk.delta_chunk_seed(vals, drows, dst,
                                                            eb),
            "delta_chunk_seed_moved": lambda: dk.delta_chunk_seed(
                scratch, drows, every, eb)}))
        out[what] = r
        print(f"[timing] {what}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in r.items()), flush=True)
    # ------------------------------------------------- device pass split
    import time

    from torch.profiler import ProfilerActivity, profile

    from sprintz_tpu_torch import decoder
    from sprintz_tpu_torch.stream_format import read_metadata_rle

    def host_ms(fn) -> float:
        torch.cuda.synchronize()
        c = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - c) * 1e3

    srng = np.random.default_rng(0)
    for what, nrows, nd, es in (("u8 walk 8 MiB", 1 << 17, 64, 1),
                                ("u8 d4 walk 4 MiB", 1 << 20, 4, 1)):
        x = walk_stream(srng, nrows, nd, es)
        buf, sc = checkpoint.compress_with_sidecar(x.reshape(-1), nd, "xff",
                                                   device=dev)
        ng, _, _ = read_metadata_rle(buf)
        lowdim = nd <= 4 // es
        idx = decoder.walk_headers(buf, ng, nd, es, lowdim)
        up = decoder.upload_payload(decoder.gather_payloads(buf, idx), idx,
                                    dev)
        states = np.zeros((sc.states.shape[0], 3, nd), np.int32)
        states[:] = sc.states
        chunks = (sc.row_offsets // 8, states)
        fns = {"serial": lambda: decoder.decode_device(
                   *up, idx.total_rows, es, "xff", lowdim),
               "chunks": lambda: decoder.decode_device(
                   *up, idx.total_rows, es, "xff", lowdim, chunks=chunks)}
        times = {k: [] for k in fns}
        for fn in fns.values():
            fn()
        for _ in range(args.reps):
            for k in ("serial", "chunks", "chunks", "serial"):
                times[k].append(host_ms(fns[k]))
        r = {k: statistics.median(v) for k, v in times.items()}
        out[what]["device_pass_ms"] = r
        print(f"[device pass] {what}: host clock to a synchronize, serial "
              f"{r['serial']:.4f} ms, chunks {r['chunks']:.4f} ms", flush=True)
        for k, fn in fns.items():
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            print(f"[device pass] {what} {k}, torch.profiler:\n"
                  + prof.key_averages().table(sort_by="self_cpu_time_total",
                                              row_limit=12), flush=True)
    print(json.dumps({"card": smi, "reps": args.reps, "streams": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
