"""One process of a multi-process check of ``mp_compress`` and
``mp_decompress``.

Start one a rank, with torch's variables set (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``):

    python -m sprintz_tpu_torch.parallel.mp_check --backend gloo \\
        --device cpu --out DIR [--large]

Each process holds only its ``host_local_elems`` slice of each case's
stream, compresses it with ``mp_compress``, checks the bytes against the
port's single-device ``encoder.compress`` (run on the same device), writes
them to ``DIR/rank<r>_case<i>.bin`` (so that a caller can hold them to
another encoder), decodes them with ``mp_decompress`` and checks the
values. The cases: delta and xff, u8 and u16, lengths with a tail, and a
constant run across the middle (RLE runs that cross the process
boundary); ``--large`` adds the 8 MiB u8 walk (131072 x 64), delta and
xff. The last line of ``DIR/rank<r>.out`` is ``OK`` and the cases checked,
and the exit code is 0, or the process exits 1.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import traceback

import numpy as np

# (codec, dtype, ndims, elements): row-major ndims (u8 > 4, u16 > 2)
SMALL = [("delta", np.uint8, 7, 7 * 8 * 53 + 11), ("xff", np.uint8, 5, 5 * 8 * 40),
         ("delta", np.uint16, 6, 6 * 8 * 37 + 5), ("xff", np.uint16, 3, 3 * 8 * 45 + 2)]
LARGE = [("delta", np.uint8, 64, 131072 * 64), ("xff", np.uint8, 64, 131072 * 64)]


def cases(large: bool = False) -> list[tuple[str, type, int, np.ndarray]]:
    """(codec, dtype, ndims, flat) of every case, from a fixed seed."""
    rng = np.random.default_rng(20261017)
    out = []
    for codec, dt, ndims, n in SMALL + (LARGE if large else []):
        hi = 1 << (8 * np.dtype(dt).itemsize)
        flat = (np.cumsum(rng.integers(-6, 7, n)) % hi).astype(dt)
        # a constant run: zero deltas, RLE across the process boundary
        a = n // 3
        flat[a:a + min(800, n // 3)] = flat[a]
        out.append((codec, dt, ndims, flat))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--device", required=True)
    ap.add_argument("--out", required=True, type=pathlib.Path)
    ap.add_argument("--large", action="store_true")
    args = ap.parse_args(argv)

    from sprintz_tpu_torch import encoder
    from sprintz_tpu_torch.parallel import multihost as mh

    if not mh.maybe_init_distributed(args.backend):
        raise RuntimeError("mp_check: MASTER_ADDR, MASTER_PORT, WORLD_SIZE "
                           "and RANK must be set")
    mesh = mh.global_mesh(args.device)
    checked = []
    for i, (codec, dt, ndims, flat) in enumerate(cases(args.large)):
        what = f"{codec}/{np.dtype(dt).name}/d{ndims}/n{flat.size}"
        sl = mh.host_local_elems(flat.size, ndims)
        got = mh.mp_compress(flat[sl].copy(), flat.size, ndims, codec, mesh)
        want = encoder.compress(flat, ndims, codec, device=mesh.device)
        if got != want:
            raise AssertionError(f"mp_compress {what}: {len(got)} bytes, "
                                 f"compress {len(want)}, not equal")
        (args.out / f"rank{mesh.rank}_case{i}.bin").write_bytes(got)
        dec = mh.mp_decompress(got, codec, np.dtype(dt).itemsize, mesh)
        if not np.array_equal(dec, flat):
            raise AssertionError(f"mp_decompress {what}: values differ")
        checked.append(what)
    (args.out / f"rank{mesh.rank}.out").write_text(
        "OK " + " ".join(checked) + "\n")
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    try:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    finally:
        sys.exit(code)
