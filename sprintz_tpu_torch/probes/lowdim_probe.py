#!/usr/bin/env python3
"""Time the lowdim layout's two kernels on the card against an earlier
pair, and say where their time goes: the encode pass
(``csrc/pack.cu``'s ``encode_lowdim_kernel``) and the delta decode
(``csrc/decode.cu``'s ``decode_lowdim_kernel``, and its raw mode).

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    git archive 797c0fd sprintz_tpu_torch/csrc | tar -x -C build/parent
    python3 sprintz_tpu_torch/probes/lowdim_probe.py --old build/parent/sprintz_tpu_torch/csrc

``--old`` is a ``csrc`` whose ``decode.cu`` has ``sprintz_unpack_lowdim``
(the lowdim unpack, K1's output contract) and ``sprintz_prefix_finish``
(K2), and whose ``pack.cu`` has ``sprintz_pack_dims_lowdim``: the pair
that the current kernels replace. At bench.py's lowdim stream (1M rows x
4 dims of a u8 walk) and its u16 twin (1M x 2), their payloads as the
decoder uploads them, it

- times, in turns in one process (old, new, new, old), the old decode
  (the status memset, the unpack and K2, by their C entry points) against
  the new decode; the old encode (the PyTorch passes of the earlier
  ``encode_device``: the widening, the delta, the block max, the widths,
  header fields and sums, the casts to u8, and the old pack) against the
  new encode pass; and the new decode against variants of its source
  (``VARIANTS``): one that zeroes its status words with a memset before
  each launch, where the kernel's last span otherwise zeroes them, and,
  to split its time, one that takes its span from blockIdx and not a
  ticket (safe only where every CTA is resident at once, as at these
  sizes), one without the look-back (wrong values, timed only), one
  that looks back 32 words a round and not 128, one whose look-back loads
  its status words relaxed at the card's scope and not volatile, and two
  with half as many spans (twice the blocks a thread, or CTAs of 512
  threads);
- times each by CUDA events (median of 25, the L2 flushed before each by
  writing 1 GiB, as ``chip_smoke.py`` does) and reads its kernels' device
  time from ``torch.profiler`` with a warm L2, beside the byte bound;
- checks that every version gives the same bytes before it times it.

The last line is a JSON object of every time. Not part of the port's path
and not imported by it.
"""

from __future__ import annotations

import argparse
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
# larger spans outgrow the default 48 KB of shared memory: opt in
OPT_IN = ('  static_assert(smem <= SMEM_DEFAULT, "the lowdim decode stays in the default shared '
          'memory");',
          "  if (allow_smem(decode_lowdim_kernel<EB, ND, RAW>, smem) != cudaSuccess)\n"
          "    return (int)cudaErrorInvalidValue;")
# Variants of the current decode.cu: name -> [(text, replacement)]
VARIANTS = {
    # the status words zeroed by a memset before each launch: the last span
    # no longer counts the spans or zeroes the words
    "memset": [
        ("  if (!RAW && warp == 0) {  // the last span to finish zeroes the status words\n",
         "  if (false) {\n"),
        ("  // the status words are zero: the last span of every launch zeroes them\n",
         "  if (!RAW && cudaMemsetAsync(status, 0, (size_t)((nb + span - 1) / span + 1) * 8,\n"
         "                              s) != cudaSuccess)\n"
         "    return (int)cudaErrorInvalidValue;\n")],
    "no ticket": [("if (tid == 0) *s_ticket = (int32_t)atomicAdd(counters, 1u);",
                   "if (tid == 0) *s_ticket = (int32_t)blockIdx.x;")],
    "no look-back (wrong values)": [
        ("const uint32_t excl = lowdim_look_back<EB>(st, span, lane);",
         "const uint32_t excl = 0;")],
    "look-back 32 words a round": [("constexpr int LD_LOOK_BACK = 4;",
                                    "constexpr int LD_LOOK_BACK = 1;")],
    # the look-back's status loads relaxed at the card's scope, not volatile
    "relaxed status loads": [
        ("// ---- end of device helpers\n",
         "// ---- end of device helpers\n"
         "__device__ __forceinline__ unsigned long long ld_status_gpu(const unsigned long long* p) {\n"
         "  unsigned long long v;\n"
         "  asm volatile(\"ld.relaxed.gpu.global.u64 %0, [%1];\" : \"=l\"(v) : \"l\"(p) : \"memory\");\n"
         "  return v;\n"
         "}\n"),
        ("v[j] = i >= 0 ? ld_status(status + i) : FLAG_PREFIX;",
         "v[j] = i >= 0 ? ld_status_gpu(status + i) : FLAG_PREFIX;"),
        ("if (v[j] < FLAG_TOTAL) v[j] = ld_status(status + next - 32 * j - lane);",
         "if (v[j] < FLAG_TOTAL) v[j] = ld_status_gpu(status + next - 32 * j - lane);")],
    # half as many spans: twice the blocks a thread, or twice the threads
    "2K blocks a thread": [("static constexpr int K = RB == 3 ? 1 : 4 / RB;",
                            "static constexpr int K = RB == 3 ? 2 : 8 / RB;"), OPT_IN],
    "CTAs of 512 threads": [("constexpr int LD_THREADS = 256;",
                             "constexpr int LD_THREADS = 512;"), OPT_IN],
}


def nvcc_build(sources: dict[str, pathlib.Path]) -> dict[str, ctypes.CDLL]:
    """Compile each source into OUT, all at once, and load the libraries."""
    from sprintz_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {k: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"lowdim_{k}.so"), str(src)],
        stdout=subprocess.DEVNULL) for k, src in sources.items()}
    failed = [k for k, p in procs.items() if p.wait()]
    if failed:
        raise RuntimeError(f"nvcc failed: {failed}")
    return {k: ctypes.CDLL(str(OUT / f"lowdim_{k}.so")) for k in sources}


def bind(lib: ctypes.CDLL, name: str, argtypes) -> ctypes._CFuncPtr:
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=pathlib.Path, required=True,
                    help="the csrc of the pair the current kernels replace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lowdim_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from sprintz_tpu_torch import decoder, encoder
    from sprintz_tpu_torch.models import forecasters as fc
    from sprintz_tpu_torch.ops import _build
    from sprintz_tpu_torch.ops import decode_kernels as dk
    from sprintz_tpu_torch.ops import pack_kernels as pk
    from sprintz_tpu_torch.ops.bitmath import block_widths_lowdim, header_value
    from sprintz_tpu_torch.stream_format import read_metadata_rle

    dev = torch.device("cuda")
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {"old_decode": args.old / "decode.cu", "old_pack": args.old / "pack.cu"}
    for k, edits in VARIANTS.items():
        variant = (_build.CSRC / "decode.cu").read_text()
        for old, new in edits:
            assert variant.count(old) == 1, (k, old)
            variant = variant.replace(old, new)
        sources[k] = OUT / f"decode_{''.join(c if c.isalnum() else '_' for c in k)}.cu"
        sources[k].write_text(variant)
    _build.build()
    libs = nvcc_build(sources)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    old_unpack = bind(libs["old_decode"], "sprintz_unpack_lowdim",
                      [P, P, P, P, P, L, I, I, I, P])
    old_finish = bind(libs["old_decode"], "sprintz_prefix_finish", [P, P, P, L, I, I, P])
    old_pack = bind(libs["old_pack"], "sprintz_pack_dims_lowdim", [P, P, P, L, I, I, P])
    variant_decode = {k: bind(libs[k], "sprintz_decode_lowdim",
                              [P, P, P, P, L, I, I, I, P, I, P, P])
                      for k in VARIANTS}

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

    def call(fn, *a):
        err = fn(*a, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{fn.__name__}: CUDA error {err}")

    rng = np.random.default_rng(0)
    res = {"card": smi, "streams": {}}
    for what, nd, es in (("u8 d4 walk 4 MiB", 4, 1), ("u16 d2 walk 4 MiB", 2, 2)):
        eb = 8 * es
        x = (np.cumsum(rng.integers(-6, 7, (ROWS, nd)), axis=0) % (1 << eb)
             ).astype(np.uint8 if es == 1 else np.uint16)
        nrows = encoder.upload_rows(x, dev, narrow=True)
        buf = encoder.compress(x.reshape(-1), nd, device=dev)
        idx = decoder.walk_headers(buf, read_metadata_rle(buf)[0], nd, es, lowdim=True)
        dense, dw, _ = decoder.upload_payload(decoder.gather_payloads(buf, idx), idx, dev)
        nb = dense.shape[0]
        ntiles = -(-nb // dk.TILE_BLOCKS)
        old_status = torch.empty(-(-nb // 256) * nd + 1, dtype=torch.int64, device=dev)
        bz = torch.empty((nb * 8, nd), dtype=dk.narrow_dtype(eb), device=dev)
        toff = torch.empty((ntiles, 1, nd), dtype=torch.int32, device=dev)
        vals_old = torch.empty_like(bz)
        vals_var = {k: torch.empty_like(bz) for k in VARIANTS}
        status = {k: torch.zeros(-(-nb // dk.lowdim_span_blocks(eb, nd)) + 1,
                                 dtype=torch.int64, device=dev) for k in VARIANTS}

        def decode_old():
            call(old_unpack, dense.data_ptr(), dw.data_ptr(), bz.data_ptr(), toff.data_ptr(),
                 old_status.data_ptr(), nb, nd, eb, 0)
            call(old_finish, bz.data_ptr(), toff.data_ptr(), vals_old.data_ptr(), nb * 8, nd,
                 eb)

        def decode_variant(k):
            call(variant_decode[k], dense.data_ptr(), dw.data_ptr(), vals_var[k].data_ptr(),
                 status[k].data_ptr(), nb, nd, eb, 0, None, 0, None)

        def encode_old():
            r32 = pk.widen_rows(nrows)
            blocks = fc.delta_encode(r32, eb).reshape(-1, 8, nd)
            widths = block_widths_lowdim(blocks.amax(dim=1), es)
            dense_o = torch.empty((nb, nd, eb), dtype=torch.uint8, device=dev)
            call(old_pack, blocks.data_ptr(), widths.data_ptr(), dense_o.data_ptr(), nb, nd, es)
            return (widths.to(torch.uint8), header_value(widths, eb).to(torch.uint8), dense_o,
                    widths.sum(dim=1, dtype=torch.int32))

        fns = {
            "decode old (memset, unpack, K2)": decode_old,
            "decode new": lambda: dk.decode_delta_lowdim(dense, dw, eb),
            **{f"decode new, variant: {k}": (lambda k=k: decode_variant(k))
               for k in VARIANTS},
            "encode old (PyTorch passes, pack)": encode_old,
            "encode new": lambda: pk.encode_lowdim(nrows, es),
            "unpack raw (FIRE)": lambda: dk.unpack_dims_lowdim(dense, dw),
        }
        want = dk.decode_delta_lowdim(dense, dw, eb)
        decode_old()
        for k in VARIANTS:
            decode_variant(k)
        torch.cuda.synchronize()
        if not (torch.equal(vals_old, want)
                and all(torch.equal(v, want) for k, v in vals_var.items() if "wrong" not in k)
                and np.array_equal(decoder.download_values(want), x.reshape(-1))):
            raise AssertionError(f"{what}: the decodes differ")
        got, old = pk.encode_lowdim(nrows, es), encode_old()
        if not all(torch.equal(g, o) for g, o in zip(got, old)):
            raise AssertionError(f"{what}: the encodes differ")
        bounds = {  # bytes each function must move, over the card's rate
            "decode": nbytes(dense, dw, want),
            "encode": nbytes(nrows, *got),
            "unpack raw (FIRE)": nbytes(dense, dw, dk.unpack_dims_lowdim(dense, dw)),
        }
        r = res["streams"][what] = {"bound_ms": {k: v / MEM_BYTES_PER_S * 1e3
                                                 for k, v in bounds.items()}}
        order = [*fns, *reversed(fns)]  # old, new, ..., new, old
        times = {k: [] for k in fns}
        for k in order:
            times[k].append(time_ms(fns[k]))
        for k, fn in fns.items():
            bound = r["bound_ms"][next(b for b in bounds if k.startswith(b))]
            r[k] = {"ms": times[k], "device_ms": device_ms(fn)}
            print(f"[{what}] {k}: {', '.join(f'{t:.4f}' for t in times[k])} ms (events, "
                  f"cold L2), bound {bound:.4f} ms ({bound / min(times[k]):.0%} of it); device "
                  "ms a call (warm): " + "; ".join(f"{n} {t:.4f}" for n, t in
                                                   r[k]["device_ms"].items()), flush=True)
        # the whole device passes, as the encoder and decoder run them
        for side, fn in (("encode device pass", lambda: encoder.encode_device(
                nrows, es, "delta", True)), ("decode device pass", lambda: decoder.decode_device(
                dense, dw, torch.arange(nb, device=dev) * 8, nb * 8, es, "delta", True))):
            r[side] = {"ms": time_ms(fn), "device_ms": device_ms(fn)}
            print(f"[{what}] {side}: {r[side]['ms']:.4f} ms (events, cold L2)", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
