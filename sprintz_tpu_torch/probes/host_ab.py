"""A/B of the port's host library (``csrc/sprintz_host.cpp``) against an
earlier copy of its source, on one machine.

    python3 sprintz_tpu_torch/probes/host_ab.py --old FILE [--reps N]
        [--steps STEP ...]

Builds ``FILE`` with ``native_host``'s flags beside the current library
(its own hash, so its own file in ``build/sprintz_tpu_torch/``), makes
``chip_smoke.py``'s main-path and lowdim streams (random walks from a seed)
and their sprintz streams with the port's compress (on the card where there
is one, else on the CPU), and times every entry point of both libraries
through the same wrappers on each stream: the walk, the walk split at
the stream's sidecar checkpoints (every 16 groups, on threads), the
gather, the plan, the assembly (also its C call alone, into a buffer kept across calls, so
that the wrapper's fresh pages and its copy into a ``bytes`` show as the
difference) and the histogram. The libraries take turns (old, new, new,
old), ``--reps`` calls a turn, and each side's time is the median of its
calls, on the host's clock. Every output of the old library must equal the
new one's. ``--steps`` times only the steps named. Prints one line a
stream and entry point and a JSON line last. Not imported by the port.
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

# (name, rows, ndims, elem_sz): chip_smoke.py's walks, both layouts
STREAMS = [("u8 walk 8 MiB", 1 << 17, 64, 1), ("u16 walk 8 MiB", 1 << 16, 64, 2),
           ("u8 walk 64 MiB", 1 << 20, 64, 1), ("u8 d4 walk 4 MiB", 1 << 20, 4, 1),
           ("u16 d2 walk 4 MiB", 1 << 20, 2, 2),
           ("u8 d1 walk 256 KiB", 1 << 18, 1, 1)]


def load(native_host, src: pathlib.Path):
    """``src`` built and bound as ``native_host`` builds and binds its own."""
    saved = native_host.SRC
    native_host.SRC = src
    try:
        return native_host._library.__wrapped__()
    finally:
        native_host.SRC = saved


def on(native_host, lib, fn):
    """fn() with the wrappers calling ``lib``."""
    saved = native_host._library
    native_host._library = lambda: lib
    try:
        return fn()
    finally:
        native_host._library = saved


def equal(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
    if hasattr(a, "__dataclass_fields__"):  # a StreamIndex
        return all(equal(getattr(a, f), getattr(b, f))
                   for f in a.__dataclass_fields__)
    return a == b


def ab(native_host, libs: dict, fn, reps: int) -> dict:
    """Median ms of fn on each library, in turns old, new, new, old; raises
    if their outputs differ."""
    times = {k: [] for k in libs}
    outs = {}
    for k in ("old", "new", "new", "old"):
        for _ in range(reps):
            c = time.perf_counter()
            outs[k] = on(native_host, libs[k], fn)
            times[k].append(time.perf_counter() - c)
    if not equal(outs["old"], outs["new"]):
        raise AssertionError("the old library's output differs")
    return {k: statistics.median(v) * 1e3 for k, v in times.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=pathlib.Path, required=True)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--steps", nargs="*", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from sprintz_tpu_torch import decoder, encoder, native_host
    from sprintz_tpu_torch.constants import LOWDIM_MAX_NDIMS
    from sprintz_tpu_torch.planner import build_plan
    from sprintz_tpu_torch.stream_format import read_metadata_rle

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    libs = {"old": load(native_host, args.old.resolve()),
            "new": native_host._library()}
    gxx = subprocess.run([native_host._gxx(), "--version"], check=True,
                         capture_output=True, text=True).stdout.splitlines()[0]
    print(f"device {dev}, {gxx}, flags {' '.join(native_host.GXX_FLAGS)}",
          flush=True)
    rng = np.random.default_rng(0)
    result = {}
    for name, rows, nd, es in STREAMS:
        x = (np.cumsum(rng.integers(-6, 7, (rows, nd)), axis=0)
             % (1 << (8 * es))).astype(np.uint8 if es == 1 else np.uint16)
        flat = x.reshape(-1)
        lowdim = nd <= LOWDIM_MAX_NDIMS[es]
        buf, layout = encoder.compress_with_layout(flat, nd, device=dev)
        ng, _, _ = read_metadata_rle(buf)
        bo = layout.group_offsets[::16]
        ro = layout.group_first_rows[::16]
        w, h, d, ws = encoder.encode_device(encoder.upload_rows(x, dev), es,
                                            "delta", lowdim)
        w, h, d, ws = (w.to(torch.uint8).cpu().numpy(),
                       h.to(torch.uint8).cpu().numpy(), d.cpu().numpy(),
                       ws.cpu().numpy())
        plan = build_plan(ws == 0, flat.size, nd)
        tail = flat[flat.size - plan.remaining_elems:]
        idx = decoder.walk_headers(buf, ng, nd, es, lowdim)
        sym = np.frombuffer(buf, np.uint8)
        out = np.empty(len(buf), np.uint8)  # the assembly's C call alone

        def emit():
            n = native_host._library().sprintz_assemble_stream(
                plan.kinds.ctypes.data, plan.values.ctypes.data,
                plan.kinds.size, plan.ngroups, plan.remaining_elems,
                w.ctypes.data, h.ctypes.data, d.ctypes.data, d.shape[-1], nd,
                es, int(lowdim), tail.ctypes.data, tail.nbytes,
                out.ctypes.data, out.size, ws.ctypes.data, None, None, 0)
            return n  # its bytes are the assemble step's, checked there

        steps = {
            "walk": lambda: decoder.walk_headers(buf, ng, nd, es, lowdim),
            "walk at checkpoints": lambda: decoder.walk_headers_parallel(
                buf, ng, nd, es, bo, ro, 16, lowdim),
            "gather": lambda: decoder.gather_payloads(buf, idx),
            "plan": lambda: build_plan(ws == 0, flat.size, nd),
            "assemble": lambda: encoder.assemble_stream(
                plan, w, h, d, nd, es, tail, lowdim, ws),
            "assemble, C call into a kept buffer": emit,
            "histogram": lambda: native_host.histogram(sym),
        }
        result[name] = {}
        for step, fn in steps.items():
            if args.steps is not None and step not in args.steps:
                continue
            r = result[name][step] = ab(native_host, libs, fn, args.reps)
            print(f"[host_ab] {name} {step}: old {r['old']:.3f} ms, new "
                  f"{r['new']:.3f} ms", flush=True)
        if encoder.assemble_stream(plan, w, h, d, nd, es, tail, lowdim,
                                   ws) != buf:
            raise AssertionError(f"{name}: assembly differs from compress")
    print(json.dumps({"host_ab": result}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
