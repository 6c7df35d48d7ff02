#!/usr/bin/env python3
"""Time the lowdim layout's kernels on the card and say where their time
goes: ``pack_dims_lowdim`` (``csrc/pack.cu``), the lowdim unpack in both
modes (``csrc/decode.cu``'s ``unpack_lowdim_kernel``) and K2
``prefix_finish`` at the lowdim widths.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 sprintz_tpu_torch/probes/lowdim_probe.py

At bench.py's lowdim stream (1M rows x 4 dims of a u8 walk) and its u16
twin (1M x 2), their payloads as the decoder uploads them, it

- times each wrapper by CUDA events (median of 25, the L2 flushed before
  each by writing 1 GiB, as ``chip_smoke.py`` does) and takes each
  kernel's device time from ``torch.profiler`` with a warm L2, so that
  launch and cold-cache costs show apart from the kernels';
- builds variants of the current ``decode.cu`` (VARIANTS: other span
  sizes, and one without the look-back, whose offsets are wrong and which
  is timed only) into ``build/sprintz_tpu_torch/probes/``, checks each
  right one against the plain version, and times them in turns with the
  current one;
- times K2 at every lowdim width (u8 D 1-4, u16 D 1-2) at 1M rows beside
  its byte bound.

The last line is a JSON object of every time. Not part of the port's path
and not imported by it.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
OUT = ROOT / "build" / "sprintz_tpu_torch" / "probes"
REPS = 25
ROWS = 1 << 20
MEM_BYTES_PER_S = 3.35e12  # H100 SXM
LOOK_BACK_CALL = "const uint32_t excl = look_back(status, span, ndims, tid, span_total);"
# spans above 8 tiles outgrow the default 48 KB of shared memory: opt in
OPT_IN = ('  static_assert(smem <= SMEM_DEFAULT, "the lowdim unpack stays in the default '
          'shared memory");',
          "  if (allow_smem(unpack_lowdim_kernel<EB, RAW>, smem) != cudaSuccess)\n"
          "    return (int)cudaErrorInvalidValue;")
# Variants of the current decode.cu: name -> [(text, replacement)]
VARIANTS = {
    "spans of 4 tiles": [("constexpr int LD_TILES = 8;", "constexpr int LD_TILES = 4;")],
    "spans of 16 tiles": [("constexpr int LD_TILES = 8;", "constexpr int LD_TILES = 16;"),
                          OPT_IN],
    "spans of 32 tiles": [("constexpr int LD_TILES = 8;", "constexpr int LD_TILES = 32;"),
                          OPT_IN],
    # the spans publish and wait for nothing: offsets within a span only
    "no look-back (wrong offsets)": [(LOOK_BACK_CALL, "const uint32_t excl = 0;")],
}
SPAN_TILES = {"current": 8, "spans of 4 tiles": 4, "spans of 16 tiles": 16,
              "spans of 32 tiles": 32, "no look-back (wrong offsets)": 8}


def slug(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lowdim_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from sprintz_tpu_torch import decoder, encoder
    from sprintz_tpu_torch.models import forecasters as fc
    from sprintz_tpu_torch.ops import _build
    from sprintz_tpu_torch.ops import decode_kernels as dk
    from sprintz_tpu_torch.ops import pack_kernels as pk
    from sprintz_tpu_torch.ops.bitmath import block_widths_lowdim
    from sprintz_tpu_torch.stream_format import read_metadata_rle

    dev = torch.device("cuda")
    OUT.mkdir(parents=True, exist_ok=True)
    srcs = {}
    for name, edits in VARIANTS.items():
        src = (_build.CSRC / "decode.cu").read_text()
        for old, new in edits:
            assert src.count(old) == 1, (name, old)
            src = src.replace(old, new)
        path = OUT / f"lowdim_{slug(name)}.cu"
        path.write_text(src)
        srcs[name] = path
    procs = {k: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"lowdim_{slug(k)}.so"),
         str(p)], stdout=subprocess.DEVNULL) for k, p in srcs.items()}
    _build.build()
    failed = [k for k, p in procs.items() if p.wait()]
    if failed:
        raise RuntimeError(f"nvcc failed: {failed}")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    unpack = {"current": _build._libraries()["decode"].sprintz_unpack_lowdim}
    for k in VARIANTS:
        fn = ctypes.CDLL(str(OUT / f"lowdim_{slug(k)}.so")).sprintz_unpack_lowdim
        fn.argtypes = [P, P, P, P, P, L, I, I, I, P]
        fn.restype = I
        unpack[k] = fn

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    def device_ms(fn) -> dict:
        """torch.profiler's device time a call, by kernel, over REPS warm
        calls."""
        fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0))
            if us > 0:
                out[e.key] = us / REPS / 1e3
        return out

    def nbytes(*ts) -> int:
        return sum(t.numel() * t.element_size() for t in ts)

    rng = np.random.default_rng(0)
    res = {"card": smi, "streams": {}, "k2": {}}
    for what, nd, es in (("u8 d4 walk 4 MiB", 4, 1), ("u16 d2 walk 4 MiB", 2, 2)):
        eb = 8 * es
        x = (np.cumsum(rng.integers(-6, 7, (ROWS, nd)), axis=0) % (1 << eb)
             ).astype(np.uint8 if es == 1 else np.uint16)
        rows = encoder.upload_rows(x, dev)
        blocks = fc.delta_encode(rows, eb).reshape(-1, 8, nd)
        widths = block_widths_lowdim(blocks.amax(dim=1), es)
        buf = encoder.compress(x.reshape(-1), nd, device=dev)
        idx = decoder.walk_headers(buf, read_metadata_rle(buf)[0], nd, es, lowdim=True)
        dense, dw, _ = decoder.upload_payload(
            decoder.gather_payloads(buf, idx), idx, dev)
        nb = dense.shape[0]
        bz, toff = dk.unpack_zz_lowdim(dense, dw, eb)
        want = dk.unpack_zz_lowdim_plain(dense, dw, eb)
        bz2 = bz.reshape(-1, nd)
        r = res["streams"][what] = {}
        fns = {
            "pack_lowdim": lambda: pk.pack_dims_lowdim(blocks, widths, es),
            "unpack_lowdim": lambda: dk.unpack_zz_lowdim(dense, dw, eb),
            "unpack_lowdim_raw": lambda: dk.unpack_dims_lowdim(dense, dw),
            "prefix_finish": lambda: dk.prefix_finish(bz2, toff, eb),
        }
        for k, fn in fns.items():
            r[k] = {"ms": time_ms(fn), "device_ms": device_ms(fn)}
            print(f"[{what}] {k}: {r[k]['ms']:.4f} ms (events, cold L2); device ms a "
                  "call (warm): " + "; ".join(f"{n} {t:.4f}" for n, t in
                                              r[k]["device_ms"].items()), flush=True)

        # the variants in turns with the current kernel, by the C entry alone
        stream = torch.cuda.current_stream().cuda_stream
        ntiles = -(-nb // dk.TILE_BLOCKS)
        status = torch.empty(-(-nb // (4 * dk.TILE_BLOCKS)) * nd + 1, dtype=torch.int64,
                             device=dev)
        outs = {k: (torch.empty_like(bz), torch.empty((ntiles, 1, nd), dtype=torch.int32,
                                                      device=dev)) for k in unpack}

        def run(k):
            o, t = outs[k]
            err = unpack[k](dense.data_ptr(), dw.data_ptr(), o.data_ptr(), t.data_ptr(),
                            status.data_ptr(), nb, nd, eb, 0, stream)
            if err:
                raise RuntimeError(f"{k}: CUDA error {err}")

        for k in unpack:
            run(k)
            torch.cuda.synchronize()
            if "wrong" not in k and not (torch.equal(outs[k][0], want[0])
                                         and torch.equal(outs[k][1], want[1])):
                raise AssertionError(f"{what} {k}: differs from the plain version")
        order = ["current", *VARIANTS, "current"]
        times = {k: [] for k in unpack}
        for k in order:
            times[k].append(time_ms(lambda: run(k)))
        r["variants"] = {k: min(v) for k, v in times.items()}
        for k, v in times.items():
            print(f"[{what}] unpack_lowdim {k} (spans of {SPAN_TILES[k]} tiles, "
                  f"{-(-nb // (SPAN_TILES[k] * dk.TILE_BLOCKS))} CTAs): "
                  + ", ".join(f"{t:.4f}" for t in v) + " ms", flush=True)
        del blocks, widths, rows

    # K2 at every lowdim width, 1M rows
    for nd, es in ((1, 1), (2, 1), (3, 1), (4, 1), (1, 2), (2, 2)):
        eb = 8 * es
        bz = torch.randint(0, 1 << eb, (ROWS, nd), dtype=torch.int32, device=dev)
        bz = dk.narrow(bz, eb)
        toff = torch.zeros((ROWS // dk.TILE_ROWS, 1, nd), dtype=torch.int32, device=dev)
        ms = time_ms(lambda: dk.prefix_finish(bz, toff, eb))
        bound = nbytes(bz, toff, bz) / MEM_BYTES_PER_S * 1e3
        res["k2"][f"u{eb} D {nd}"] = {"ms": ms, "bound_ms": bound}
        print(f"[K2] u{eb} D {nd}, 1M rows: {ms:.4f} ms, byte bound {bound:.4f} ms "
              f"({ms / bound:.1f}x)", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
