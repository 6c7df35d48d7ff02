#!/usr/bin/env python3
"""Time FIRE's serial scans (``csrc/fire.cu``'s ``sprintz_fire_scan``:
encode, encode with its per-block states, decode) as committed beside an
earlier ``fire.cu`` whose entry point has one ``state`` pointer and no
carries, in turns on one card, and the committed scans with their init and
final carries beside them.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 sprintz_tpu_torch/probes/carry_probe.py --old DIR

``DIR`` holds the earlier ``fire.cu`` (for example ``git archive 04bb02d
sprintz_tpu_torch/csrc | tar -x -C build/parent``, then
``build/parent/sprintz_tpu_torch/csrc``). The streams are the 8 MiB u8 and
u16 random walks (131072 x 64, 65536 x 64) and the 4 MiB u8 d4 walk with
the full-precision coefficient; each time is the median of ``--reps``
rounds of (old, new, new, old) CUDA-event timings, the L2 flushed before
each. Outputs of old and new must be equal. The last line is a JSON object
of every time. Not part of the port's path and not imported by it.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=pathlib.Path,
                    help="the directory of the earlier fire.cu")
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from sprintz_tpu_torch.models import forecasters as fc
    from sprintz_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("carry_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    OUT.mkdir(parents=True, exist_ok=True)
    old_so = OUT / "fire_old_carries.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(old_so),
                    str(args.old / "fire.cu")], check=True,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    _build.build()
    old = ctypes.CDLL(str(old_so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    old.sprintz_fire_scan.argtypes = [P, P, P, L, I, I, I, I, P]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def old_scan(src, state, dst, nb, nd, eb, decode, trunc):
        err = old.sprintz_fire_scan(src.data_ptr(),
                                    None if state is None else state.data_ptr(),
                                    dst.data_ptr(), nb, nd, eb, decode,
                                    int(trunc), stream)
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

    rng = np.random.default_rng(0)
    res = {"card": smi}
    for what, nrows, nd, eb, trunc in (("u8 walk 8 MiB", 1 << 17, 64, 8, True),
                                       ("u16 walk 8 MiB", 1 << 16, 64, 16, True),
                                       ("u8 d4 walk 4 MiB", 1 << 20, 4, 8, False)):
        nb = nrows // 8
        rows = torch.from_numpy((np.cumsum(rng.integers(-6, 7, (nrows, nd)), axis=0)
                                 % (1 << eb)).astype(np.int32)).to(dev)
        errs = fc.fire_encode(rows, eb, trunc)
        zz = errs.to(torch.uint8) if eb == 8 else errs
        st0 = torch.zeros((3, nd), dtype=torch.int32, device=dev)
        o_errs = torch.empty_like(errs)
        o_words = torch.empty((nb, nd, 4), dtype=torch.int32, device=dev)
        o_vals = torch.empty((nrows, nd), device=dev,
                             dtype=torch.uint8 if eb == 8 else torch.uint16)
        new_e, new_c = fc.fire_encode(rows, eb, trunc, states=True)
        new_v = fc.fire_decode(zz, eb, truncate_coeffs=trunc)
        old_scan(rows, None, o_errs, nb, nd, eb, 0, trunc)
        old_scan(rows, o_words, o_errs, nb, nd, eb, 0, trunc)
        old_scan(zz, None, o_vals, nb, nd, eb, 1, trunc)
        torch.cuda.synchronize()
        if not (torch.equal(o_errs, new_e) and torch.equal(o_vals, new_v)
                and torch.equal(o_words[..., :3].transpose(1, 2), new_c)):
            raise AssertionError(f"{what}: the old and new scans differ")
        pairs = {
            "encode": (lambda: old_scan(rows, None, o_errs, nb, nd, eb, 0, trunc),
                       lambda: fc.fire_encode(rows, eb, trunc)),
            "encode_states": (lambda: old_scan(rows, o_words, o_errs, nb, nd, eb, 0,
                                               trunc),
                              lambda: fc.fire_encode(rows, eb, trunc, states=True)),
            "decode": (lambda: old_scan(zz, None, o_vals, nb, nd, eb, 1, trunc),
                       lambda: fc.fire_decode(zz, eb, truncate_coeffs=trunc)),
            "encode_carries": (None, lambda: fc.fire_encode(
                rows, eb, trunc, init_state=st0, final=True)),
            "decode_carries": (None, lambda: fc.fire_decode(
                zz, eb, st0, trunc, final=True)),
        }
        row = {}
        for name, (fo, fn) in pairs.items():
            for f in (fo, fn):
                if f is not None:
                    for _ in range(3):
                        f()
            t = {"old": [], "new": []}
            for _ in range(args.reps):
                for key in ("old", "new", "new", "old"):
                    f = fo if key == "old" else fn
                    if f is not None:
                        t[key].append(once(f))
            row[name] = {k: statistics.median(v) for k, v in t.items() if v}
            print(f"[carry] {what} {name}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in row[name].items())
                + (f" (new / old {row[name]['new'] / row[name]['old']:.4f})"
                   if "old" in row[name] else ""), flush=True)
        res[what] = row
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
