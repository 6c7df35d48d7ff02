#!/usr/bin/env python3
"""Time ``csrc/fire.cu``'s kernels on the card, whole and with parts taken
out or changed, to see which warp role bounds them.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 sprintz_tpu_torch/probes/fire_ablate.py

It copies ``csrc/fire.cu``, turns a few of its constants and loops into
``-D`` switches by exact text replacement (an assert fails when the source
no longer has the text), builds one library a variant into
``build/sprintz_tpu_torch/probes/`` and times encode and decode of the
8 MiB u8 and u16 random walks (CUDA events, median of 11 after warm-up,
the L2 flushed before each). A variant that skips a role's work gives
wrong output; only its time is read. A last build adds ``clock64``
counters to each role and prints, in cycles a block, how long the chain
warp, the first finisher and the first loader waited on their barriers
and ran in all.

Not part of the port's path and not imported by it.
"""

from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
SOURCE = HERE.parent / "csrc" / "fire.cu"
OUT = ROOT / "build" / "sprintz_tpu_torch" / "probes"
NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
REPS = 11
BASE = dict(SKIP_ECHAIN=0, SKIP_EFIN=0, SKIP_DCHAIN=0, SKIP_DFIN=0,
            SKIP_LOADS=0, N_TEAMS=2, N_FIN=4, N_SCHED=4, N_STAGES=8)
VARIANTS = {
    "as committed": {},
    "no chain arithmetic": dict(SKIP_ECHAIN=1, SKIP_DCHAIN=1),
    "no finisher work": dict(SKIP_EFIN=1, SKIP_DFIN=1),
    "no loads": dict(SKIP_LOADS=1),
    "chain only": dict(SKIP_EFIN=1, SKIP_DFIN=1, SKIP_LOADS=1),
    "chain shares its scheduler": dict(N_SCHED=1024),
    "2 finishers": dict(N_FIN=2), "3 finishers": dict(N_FIN=3),
    "8 finishers": dict(N_FIN=8),
    "1 loader team": dict(N_TEAMS=1), "3 loader teams": dict(N_TEAMS=3),
    "4 stages": dict(N_STAGES=4),
}
WAITS = ("mbar_wait(ring.loaded + s, Ring::round_parity(t));",
         "mbar_wait(ring.free_ + s, Ring::round_parity(t) ^ 1u);",
         "mbar_wait(ring.chained + s, Ring::round_parity(t));")


def replace(src: str, old: str, new: str, count: int = 1) -> str:
    assert src.count(old) == count, (old, src.count(old))
    return src.replace(old, new)


def switched(src: str) -> str:
    """The source with its role loops and constants behind -D switches."""
    nblk = "const int nblk = blocks_in_tile(nb, t);"
    parts = src.split(nblk)
    assert len(parts) == 5, len(parts)
    # in the order of the source: encode's chain and finishers, decode's
    names = ("SKIP_ECHAIN", "SKIP_EFIN", "SKIP_DCHAIN", "SKIP_DFIN")
    src = parts[0] + "".join(
        f"const int nblk = {name} ? 0 : blocks_in_tile(nb, t);" + rest
        for name, rest in zip(names, parts[1:]))
    src = replace(src, "v[j + 1] = FULL || j < left ?",
                  "v[j + 1] = !SKIP_LOADS && (FULL || j < left) ?")
    src = replace(src, "u[j] = FULL || j < left ?",
                  "u[j] = !SKIP_LOADS && (FULL || j < left) ?")
    src = replace(src, "constexpr int LOAD_TEAMS = 2;",
                  "constexpr int LOAD_TEAMS = N_TEAMS;")
    src = replace(src, "constexpr int FINISHERS = 4;",
                  "constexpr int FINISHERS = N_FIN;")
    src = replace(src, "constexpr int SCHEDULERS = 4;",
                  "constexpr int SCHEDULERS = N_SCHED;")
    return replace(src, "constexpr int STAGES = 8; ",
                   "constexpr int STAGES = N_STAGES; ")


def clocked(src: str) -> str:
    """The source with clock64 counters around each role's waits and loop:
    fire_dbg[0:2] the chain's wait and total, [2:4] the first finisher's,
    [4:6] the first loader's, of CTA 0."""
    src = replace(src, "namespace {\n",
                  "namespace {\n__device__ long long fire_dbg[8];\n")
    for call in WAITS:
        src = replace(src, call, "{ long long c0_ = clock64(); " + call
                      + " dbg_wait += clock64() - c0_; }", 2)

    def role(src, start, end, slot, cond):
        src = replace(src, start, start + "\n    long long dbg_wait = 0; "
                      "const long long dbg_start = clock64();", 2)
        lines = end.split("\n")
        return replace(src, end, lines[0] + "\n    }\n"
                       f"    if (lane == 0 && blockIdx.x == 0 && ({cond})) {{ "
                       f"fire_dbg[{slot}] = dbg_wait; fire_dbg[{slot} + 1] = "
                       "clock64() - dbg_start; }\n" + "\n".join(lines[2:]), 2)

    src = role(src, "  if (warp == 0) {",
               "      mbar_arrive(ring.chained + s);\n    }\n  } else if", 0,
               "true")
    src = role(src, "    const int b0 = (lw % TEAM_WARPS) * LOAD_BLOCKS;",
               "      mbar_arrive(ring.loaded + s);\n    }\n  } else {", 4,
               "lw == 0")
    src = role(src, "    const int f = helper;",
               "      mbar_arrive(ring.free_ + s);\n    }\n  }\n}", 2, "f == 0")
    return replace(
        src, 'extern "C" {\n',
        'extern "C" {\nint sprintz_fire_dbg(long long* host) { return (int)'
        "cudaMemcpyFromSymbol(host, fire_dbg, sizeof(long long) * 8); }\n")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fire_ablate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    OUT.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    (OUT / "fire_switched.cu").write_text(switched(src))
    (OUT / "fire_clocked.cu").write_text(clocked(src))
    builds = {}
    for k, v in VARIANTS.items():
        lib = OUT / f"fire_{k.replace(' ', '_')}.so"
        builds[lib] = subprocess.Popen(
            [NVCC, *NVCC_FLAGS, *[f"-D{a}={b}" for a, b in {**BASE, **v}.items()],
             "-o", str(lib), str(OUT / "fire_switched.cu")])
    clocked_lib = OUT / "fire_clocked.so"
    builds[clocked_lib] = subprocess.Popen(
        [NVCC, *NVCC_FLAGS, "-o", str(clocked_lib), str(OUT / "fire_clocked.cu")])
    failed = [str(lib) for lib, proc in builds.items() if proc.wait()]
    if failed:
        raise RuntimeError(f"nvcc failed: {failed}")

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    rng = np.random.default_rng(0)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def time_ms(fn) -> float:
        for _ in range(2):
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

    def scan_of(lib_path):
        lib = ctypes.CDLL(str(lib_path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sprintz_fire_scan.argtypes = [p, p, p, p, p, ll, i, i, i, i, p]

        def scan(src_t, dst_t, nb, ndims, eb, decode):
            err = lib.sprintz_fire_scan(src_t.data_ptr(), None, None, None,
                                        dst_t.data_ptr(), nb, ndims, eb, decode, 1,
                                        stream)
            if err:
                raise RuntimeError(f"{lib_path.name}: CUDA error {err}")
        return lib, scan

    for eb, nrows, ndims in ((8, 1 << 17, 64), (16, 1 << 16, 64)):
        nb = nrows // 8
        rows = torch.from_numpy(
            (np.cumsum(rng.integers(-6, 7, (nrows, ndims)), axis=0) % (1 << eb)
             ).astype(np.int32)).to(dev)
        errs = torch.empty_like(rows)
        _, scan = scan_of(OUT / "fire_as_committed.so")
        scan(rows, errs, nb, ndims, eb, 0)
        torch.cuda.synchronize()
        zz = errs.to(torch.uint8) if eb == 8 else errs.clone()
        vals = torch.empty((nrows, ndims), device=dev,
                           dtype=torch.uint8 if eb == 8 else torch.uint16)
        for k in VARIANTS:
            _, scan = scan_of(OUT / f"fire_{k.replace(' ', '_')}.so")
            enc = time_ms(lambda: scan(rows, errs, nb, ndims, eb, 0))
            dec = time_ms(lambda: scan(zz, vals, nb, ndims, eb, 1))
            print(f"[ablate] u{eb} nb {nb} D {ndims}, {k}: encode {enc:.4f} ms, "
                  f"decode {dec:.4f} ms", flush=True)
        lib, scan = scan_of(clocked_lib)
        host = (ctypes.c_longlong * 8)()
        for side, args in (("encode", (rows, errs, nb, ndims, eb, 0)),
                           ("decode", (zz, vals, nb, ndims, eb, 1))):
            scan(*args)
            torch.cuda.synchronize()
            lib.sprintz_fire_dbg(host)
            chain, fin, load = (
                f"{host[j] / nb:.1f} of {host[j + 1] / nb:.1f}" for j in (0, 2, 4))
            print(f"[clocks] u{eb} {side}, cycles a block waited of all: chain "
                  f"{chain}, first finisher {fin}, first loader {load}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
