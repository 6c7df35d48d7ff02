#!/usr/bin/env python3
"""Time, on the card, the pieces that ``csrc/fire.cu``'s design rests on.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 sprintz_tpu_torch/probes/fire_micro.py

Builds ``fire_micro.cu`` (beside this file) into
``build/sprintz_tpu_torch/probes/`` and prints SM cycles, read with
``clock64`` inside the kernels:

- the latency of dependent chains of one or two integer instructions
  (what a step of the FIRE chain costs, and what it costs to leave the
  multiplier's pipe between two multiply-adds);
- the chain warps' loops alone in a CTA, cycles a block: an earlier form
  with and without reading the next block's operands ahead, and the form
  the kernels have;
- the rate at which 1, 2, 4 and 8 warps of a CTA store rows of 32 lanes,
  by the width of the store.

Not part of the port's path and not imported by it.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
OUT = ROOT / "build" / "sprintz_tpu_torch" / "probes"
NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
LATENCY_ITERS = 100000
TILES = 1024  # of 16 blocks
STORE_BLOCKS = 16384


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fire_micro: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    lib_path = OUT / "fire_micro.so"
    subprocess.run([NVCC, *NVCC_FLAGS, "-o", str(lib_path),
                    str(HERE / "fire_micro.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.fire_micro_latency.argtypes = [i, i, p]
    lib.fire_micro_pairs.argtypes = [i, i, i, p]
    lib.fire_micro_cells.argtypes = [i, i, i, p]
    lib.fire_micro_stores.argtypes = [i, i, i, i, i, p, p]
    cyc = torch.zeros(2, dtype=torch.int64, device="cuda")

    def cycles(fn, *args) -> int:
        for _ in range(2):  # the second run finds the clock up
            err = fn(*args, cyc.data_ptr())
            if err:
                raise RuntimeError(f"{fn.__name__}{args}: CUDA error {err}")
        return int(cyc[0])

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    for mode, name in enumerate((
            "multiply-add", "multiply-add, byte permute",
            "multiply-add, shift by 16", "two-way dot product",
            "high half of a product, add")):
        c = cycles(lib.fire_micro_latency, mode, LATENCY_ITERS)
        print(f"[latency] {name}: {c / LATENCY_ITERS / 8:.2f} cycles a step")
    for decode, side in ((1, "decode u8"), (0, "encode u8")):
        for prefetch in ((0, 1) if decode else (1,)):
            c = cycles(lib.fire_micro_pairs, decode, prefetch, TILES)
            print(f"[chain alone] {side}, 4-byte cells, operands read "
                  f"{'a block ahead' if prefetch else 'at the block'}: "
                  f"{c / TILES / 16:.1f} cycles a block")
        for unroll2 in ((0,) if decode else (0, 1)):
            c = cycles(lib.fire_micro_cells, decode, unroll2, TILES)
            print(f"[chain alone] {side}, 16-byte cells"
                  f"{', dot product' if decode else ''}"
                  f"{', unrolled by 2' if unroll2 else ''}: "
                  f"{c / TILES / 16:.1f} cycles a block")
    buf = torch.zeros(STORE_BLOCKS * 8 * 129 * 4, dtype=torch.uint8,
                      device="cuda")
    for ndims, ctas in ((64, 2), (129, 5)):
        for nbytes in (1, 2, 4):
            for warps in (1, 2, 4, 8):
                c = cycles(lib.fire_micro_stores, nbytes, warps, ctas,
                           STORE_BLOCKS, ndims, buf.data_ptr())
                print(f"[stores] D {ndims}, {nbytes} B a lane, {warps} warps: "
                      f"{c / STORE_BLOCKS / 8:.1f} cycles a store over the "
                      f"CTA")
    return 0


if __name__ == "__main__":
    sys.exit(main())
