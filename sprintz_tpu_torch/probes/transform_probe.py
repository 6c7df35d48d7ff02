#!/usr/bin/env python3
"""Time FIRE's transform instantiations (the xff transform's head) beside
the codec's serial scans, and the codec's scans beside an earlier
``fire.cu``'s, in turns on one card.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 sprintz_tpu_torch/probes/transform_probe.py --old DIR [--reps N]
        [--variants]

``DIR`` holds an earlier ``fire.cu`` whose ``sprintz_fire_scan`` takes the
committed arguments (for example ``git archive c49165c
sprintz_tpu_torch/csrc | tar -x -C build/parent``, then
``build/parent/sprintz_tpu_torch/csrc``). The streams are the 8 MiB u8 and
u16 random walks (131072 x 64, 65536 x 64; numpy, seed 0). For each, in
rounds of (old, new, new, old) CUDA-event timings with the L2 flushed
before each, medians of ``--reps`` rounds: the codec's encode and decode
(truncated coefficient) from the earlier source and the committed one,
whose outputs must be equal; then the transform encode and decode beside
the committed codec's, in turns, with their ratio. With ``--variants``,
the committed ``fire.cu`` rebuilt with one of ``VARIANTS`` (text
substitutions of the transform decode's EB 16 row), whose values must be
the committed decode's, timed beside it in turns at the u16 walk. Then the
delta transform's inverse (``transforms._lag_undelta``: a wrapping prefix
over rows, each dim's column scanned as a contiguous row of the transposed
grid) beside a cumulative sum down the grid's rows (dim 0), in turns, at
the same walks' elements at D 1, 5, 64 and 129. The last line is a JSON
object of every time. Not imported by the port.
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
SRC = ROOT / "sprintz_tpu_torch" / "csrc" / "fire.cu"
XF_ROW = "word = e[r] = ((uint32_t)__mulhi((int32_t)word, cm) << 18) + e[r];"
# the transform decode's EB 16 row, other forms: (name, (old, new) pairs)
VARIANTS = [
    # the shift-add as a multiply-add by 2^18, in the multiplier's pipe (a
    # value the compiler cannot fold, so that it stays a multiply)
    ("imad18", [("  uint32_t word = 0, val = 0;\n  int32_t counter = 0;\n  for (int t = 0;",
                 "  uint32_t word = 0, val = 0;\n  int32_t counter = 0;\n"
                 "  const uint32_t k18 = (1u << 18) | (uint32_t)(cta_nblk >> 62);\n"
                 "  for (int t = 0;"),
                (XF_ROW, "word = e[r] = (uint32_t)__mulhi((int32_t)word, cm) * k18 + e[r];")]),
    # no multiply-high: (delta << 14) * (coef >> 12), bits 16-17 cleared, the
    # error added
    ("imad_mask", [(XF_ROW, "word = e[r] = (((uint32_t)((int32_t)word >> 2) * "
                            "(uint32_t)(cm >> 12)) & 0xfffc0000u) + e[r];")]),
    # the value and the gradient terms from the delta shifted out of the
    # word (the codec's advance(), a shift and a multiply-add each)
    ("shr16", [("if (r & 1) grad_sum += word * (uint32_t)m[r >> 1];",
                "if (r & 1) grad_sum = F::advance(word, m[r >> 1] << 16, grad_sum);"),
               ("          val += word;\n",
                "          val = F::advance(word, F::multiplier(1), val);\n"),
               ("signs[b * GROUP].x = EB == 8 ? val : val >> 16;",
                "signs[b * GROUP].x = val;")]),
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=pathlib.Path,
                    help="the directory of the earlier fire.cu")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from sprintz_tpu_torch import transforms
    from sprintz_tpu_torch.models import forecasters as fc
    from sprintz_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("transform_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    OUT.mkdir(parents=True, exist_ok=True)
    old_so = OUT / "fire_old_transform.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(old_so),
                    str(args.old / "fire.cu")], check=True,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    _build.build()
    old = ctypes.CDLL(str(old_so))
    old.sprintz_fire_scan.argtypes = list(_build.SIGNATURES[
        "sprintz_fire_scan"][1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def old_scan(src, dst, nb, nd, eb, decode):
        err = old.sprintz_fire_scan(src.data_ptr(), None, None, None,
                                    dst.data_ptr(), nb, nd, eb, decode, 1,
                                    stream)
        if err:
            raise RuntimeError(f"old fire.cu: CUDA error {err}")

    def once(fn) -> float:
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    def turns(a, b) -> dict:
        """Medians of (a, b, b, a) rounds after a warm-up."""
        for f in (a, b):
            for _ in range(3):
                f()
        t = {"a": [], "b": []}
        for _ in range(args.reps):
            for key in ("a", "b", "b", "a"):
                t[key].append(once(a if key == "a" else b))
        return {k: statistics.median(v) for k, v in t.items()}

    def variants(rows, raw, want) -> dict:
        """The transform decode of ``raw`` from each variant's build, held
        to the committed decode ``want`` and timed beside it in turns."""
        out = {}
        nrows, nd = rows.shape
        for name, subs in VARIANTS:
            text = SRC.read_text()
            for a, b in subs:
                if text.count(a) != 1:
                    raise AssertionError(f"variant {name}: {a!r} not found once")
                text = text.replace(a, b)
            src = OUT / f"fire_{name}.cu"
            src.write_text(text)
            so = OUT / f"fire_{name}.so"
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                            str(src)], check=True, stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
            lib = ctypes.CDLL(str(so))
            lib.sprintz_fire_scan.argtypes = list(_build.SIGNATURES[
                "sprintz_fire_scan"][1])
            got = torch.empty_like(want)

            def run(lib=lib, got=got):
                err = lib.sprintz_fire_scan(raw.data_ptr(), None, None, None,
                                            got.data_ptr(), nrows // 8, nd, 16,
                                            1, fc.MODE_TRANSFORM, stream)
                if err:
                    raise RuntimeError(f"variant {name}: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                raise AssertionError(f"variant {name}: values differ")
            t = turns(lambda: fc.fire_decode(raw, 16, transform=True), run)
            out[name] = {**t, "b / a": t["b"] / t["a"]}
            print(f"[transform] variant {name}, u16 decode, committed / "
                  f"variant: {t['a']:.4f} / {t['b']:.4f} ms (ratio "
                  f"{t['b'] / t['a']:.4f})", flush=True)
        return out

    rng = np.random.default_rng(0)
    res = {"card": smi}
    for what, nrows, eb in (("u8 walk 8 MiB", 1 << 17, 8),
                            ("u16 walk 8 MiB", 1 << 16, 16)):
        nd, nb = 64, nrows // 8
        rows = torch.from_numpy((np.cumsum(rng.integers(-6, 7, (nrows, nd)),
                                           axis=0) % (1 << eb)
                                 ).astype(np.int32)).to(dev)
        errs = fc.fire_encode(rows, eb)
        zz = errs.to(torch.uint8) if eb == 8 else errs
        raw = fc.fire_encode(rows, eb, transform=True)
        raw = (raw.to(torch.uint8) if eb == 8
               else (raw - ((raw & 0x8000) << 1)).to(torch.int16))
        o_errs = torch.empty_like(errs)
        o_vals = torch.empty((nrows, nd), device=dev,
                             dtype=torch.uint8 if eb == 8 else torch.uint16)
        old_scan(rows, o_errs, nb, nd, eb, 0)
        old_scan(zz, o_vals, nb, nd, eb, 1)
        vals = fc.fire_decode(raw, eb, transform=True)
        torch.cuda.synchronize()
        if not (torch.equal(o_errs, errs)
                and torch.equal(o_vals, fc.fire_decode(zz, eb))
                and torch.equal(vals.view(torch.int16).to(torch.int32) & 0xFFFF
                                if eb == 16 else vals.to(torch.int32), rows)):
            raise AssertionError(f"{what}: old and new scans differ, or the "
                                 f"transform decode does not invert its encode")
        row = {}
        for name, a, b in (
                ("codec encode, old / new",
                 lambda: old_scan(rows, o_errs, nb, nd, eb, 0),
                 lambda: fc.fire_encode(rows, eb)),
                ("codec decode, old / new",
                 lambda: old_scan(zz, o_vals, nb, nd, eb, 1),
                 lambda: fc.fire_decode(zz, eb)),
                ("encode, codec / transform",
                 lambda: fc.fire_encode(rows, eb),
                 lambda: fc.fire_encode(rows, eb, transform=True)),
                ("decode, codec / transform",
                 lambda: fc.fire_decode(zz, eb),
                 lambda: fc.fire_decode(raw, eb, transform=True))):
            t = turns(a, b)
            row[name] = {**t, "b / a": t["b"] / t["a"]}
            print(f"[transform] {what} {name}: {t['a']:.4f} / {t['b']:.4f} ms "
                  f"(ratio {t['b'] / t['a']:.4f})", flush=True)
        res[what] = row
        if args.variants and eb == 16:
            res[what]["variants"] = variants(rows, raw, vals)
        flat = rows.reshape(-1)
        for nd in (1, 5, 64, 129):
            def down_rows(nd=nd):  # the grid's rows, dim 0
                n = flat.numel()
                nrows = -(-n // nd)
                grid = torch.zeros(nrows * nd, dtype=torch.int64, device=dev)
                grid[:n] = flat
                acc = torch.cumsum(grid.reshape(nrows, nd), dim=0)
                return (acc & ((1 << eb) - 1)).reshape(-1)[:n].to(torch.int32)

            if not torch.equal(down_rows(), transforms._lag_undelta(
                    flat, nd, eb, None)):
                raise AssertionError(f"lag prefix D {nd}: the two differ")
            t = turns(down_rows, lambda nd=nd: transforms._lag_undelta(
                flat, nd, eb, None))
            res[what][f"lag prefix D {nd}, dim 0 / transposed"] = {
                **t, "b / a": t["b"] / t["a"]}
            print(f"[transform] {what} lag prefix D {nd}, dim 0 / transposed: "
                  f"{t['a']:.4f} / {t['b']:.4f} ms", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
