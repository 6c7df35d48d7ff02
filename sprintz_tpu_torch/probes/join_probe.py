"""The decode's join alone on the host: a copy of the MSRC-12 cell's values
(57,548,800 bytes, from a pinned buffer as the download slot is) into a
fresh block, as every call paid before the output pool, and into a
recycled one, whose pages are mapped, as ``decoder._join`` copies now; on
numpy's one thread and on the host library's ``native_host.copy`` at 1
to 8 threads (``THREADS``). The ways take turns, one copy each a round, so that
they share the host's state.

    python3 sprintz_tpu_torch/probes/join_probe.py [--rounds 40] [--bytes N]

from the root of a checkout, on the host of a machine with a CUDA card
(off CUDA the source is plain numpy). Its last line is a JSON object of
every median.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from sprintz_tpu_torch import native_host  # noqa: E402

NBYTES = 57_548_800  # the MSRC-12 cell's values: 719,360 rows x 80, u8
THREADS = (1, 2, 3, 4, 6, 8)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no card"


def source(n: int) -> np.ndarray:
    rng = np.random.default_rng(20261019)
    if torch.cuda.is_available():
        src = torch.empty(n, dtype=torch.uint8, pin_memory=True).numpy()
        src[...] = rng.integers(0, 256, n, dtype=np.uint8)
        return src
    return rng.integers(0, 256, n, dtype=np.uint8)


def copier(threads: int | None):
    if threads is None:
        def copy(dst, src):
            dst[...] = src
    else:
        def copy(dst, src):
            native_host.copy(dst, src, threads)
    return copy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--bytes", type=int, default=NBYTES)
    args = ap.parse_args(argv)
    n = args.bytes
    src = source(n)
    warm = np.empty(n, np.uint8)
    warm[...] = 0
    ways = {f"{block}.{'numpy' if t is None else f'threads{t}'}":
            (block, copier(t)) for block in ("fresh", "recycled")
            for t in (None, *THREADS)}
    for _, copy in ways.values():  # builds the library, warms the code
        copy(warm, src)
    times: dict[str, list[float]] = {k: [] for k in ways}
    for _ in range(args.rounds):
        for name, (block, copy) in ways.items():
            t0 = time.perf_counter()
            dst = np.empty(n, np.uint8) if block == "fresh" else warm
            copy(dst, src)
            times[name].append(time.perf_counter() - t0)
            if not (dst[:: 4099] == src[:: 4099]).all():
                raise AssertionError(f"{name}: wrong bytes")
            del dst
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    for k, v in times.items():
        q = statistics.quantiles([x * 1e3 for x in v], n=10)
        print(f"{k:24s} median {med[k]:8.3f} ms  p10 {q[0]:8.3f}  "
              f"p90 {q[-1]:8.3f}  {n / med[k] / 1e6:6.2f} GB/s")
    print(json.dumps({"card": card(), "bytes": n, "rounds": args.rounds,
                      "host_cores": native_host.os.cpu_count(),
                      "median_ms": med}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
