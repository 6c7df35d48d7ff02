"""The pipelined decode on the card (``decoder.decompress``'s segments):
its values held to the input at every segment plan tried, on one thread
and on four at once, a call's time at segment counts around the module's
constants, and at the module's plan against one segment on shorter
streams.

    python3 sprintz_tpu_torch/probes/pipe_probe.py [--quick]
    python3 sprintz_tpu_torch/probes/pipe_probe.py --stages [--out DIR]

from the root of a checkout on a machine with a CUDA card. The two large
inputs are the benchmark's decode inputs (``portbench``'s generator and
configurations, seed 20261018); the small ones are random walks with
constant stretches (zero runs) and a verbatim tail. Its last line is a
JSON object of every number; it raises at the first wrong value.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from sprintz_tpu_torch import decoder, encoder  # noqa: E402
from sprintz_tpu_torch.stream_format import read_metadata_rle  # noqa: E402
from sprintz_tpu_torch.utils import trace  # noqa: E402

SEED = 20261018
CELLS = ("ucr-u8-d1-xff", "ampd-u16-d3-xff")
SMALL = [(1, 1), (1, 4), (2, 2), (2, 3), (1, 8), (1, 64), (2, 17)]
# PIPE_BYTES, PIPE_GROUPS, PIPE_SEGMENTS
PLANS = [(1, 8, 12), (1, 2, 5), (1, 1, 12), (1, 1, 16)]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


class constants:
    """``decoder``'s segment constants set for a block, then put back."""

    def __init__(self, nbytes: int, groups: int, segments: int):
        self.new = dict(PIPE_BYTES=nbytes, PIPE_GROUPS=groups,
                        PIPE_SEGMENTS=segments)

    def __enter__(self):
        self.old = {k: getattr(decoder, k) for k in self.new}
        for k, v in self.new.items():
            setattr(decoder, k, v)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            setattr(decoder, k, v)
        return False


def counted(fn):
    """fn's result and the change of the decoder's counters it made."""
    before = trace.counters()
    out = fn()
    after = trace.counters()
    return out, {k: after[k] - before.get(k, 0) for k in after
                 if k.startswith("decoder.") and after[k] != before.get(k, 0)}


def decode(buf: bytes, es: int) -> np.ndarray:
    return decoder.decompress(buf, codec="xff", elem_sz=es, device="cuda")


def small_stream(rng, es: int, ndims: int, rows: int) -> np.ndarray:
    dt = np.uint8 if es == 1 else np.uint16
    x = np.cumsum(rng.integers(-9, 10, (rows, ndims)), axis=0).astype(dt)
    for _ in range(4):  # constant stretches: FIRE's zero runs
        a = int(rng.integers(0, rows - 200))
        x[a:a + int(rng.integers(40, 200))] = x[a]
    return x.reshape(-1)


def check_small(rng) -> dict:
    """Every small shape under every plan: the values of the input, and
    the one-segment decode's."""
    out = {}
    for es, nd in SMALL:
        for rows in (16 * 37 + 5, 16 * 203 + 11):
            x = small_stream(rng, es, nd, rows)
            buf = encoder.compress(x, nd, codec="xff", device="cuda")
            one = decode(buf, es)
            if not np.array_equal(one, x):
                raise AssertionError(f"u{8 * es} D{nd} rows {rows}: one "
                                     f"segment differs from the input")
            for plan in PLANS:
                with constants(*plan):
                    got, c = counted(lambda: decode(buf, es))
                if not np.array_equal(got, x):
                    raise AssertionError(f"u{8 * es} D{nd} rows {rows} plan "
                                         f"{plan}: values differ")
                out[f"u{8 * es} d{nd} r{rows} {plan}"] = c.get(
                    "decoder.decompress.segments", 0)
    return out


def large_inputs() -> dict:
    from portbench import loop

    out = {}
    for name in CELLS:
        cfg = loop.load_config(name)
        x = loop.make_inputs(cfg, {"inputs": 1}, SEED)[0]
        es = cfg["elem_sz"]
        buf = encoder.compress(x.reshape(-1), cfg["ndims"], codec="xff",
                               device="cuda")
        out[name] = (x.reshape(-1), buf, es)
    return out


def check_large(inputs) -> dict:
    out = {}
    for name, (x, buf, es) in inputs.items():
        decode(buf, es)  # the pinned slots grow here
        got, c = counted(lambda: decode(buf, es))
        if not np.array_equal(got, x):
            raise AssertionError(f"{name}: values differ")
        if c.get("decoder.upload_payload.pageable_bytes", 0) or c.get(
                "decoder.download_values.pageable_bytes", 0):
            raise AssertionError(f"{name}: pageable copies {c}")
        if c.get("decoder._Slot.take.pinned_allocs", 0):
            raise AssertionError(f"{name}: pinned slots grew again {c}")
        out[name] = c
    return out


def check_threads(inputs, nthreads: int = 4, calls: int = 5) -> dict:
    """nthreads threads decode both large inputs at once, each its own
    pipe: every answer the input's."""
    errors = []

    def work(t):
        try:
            for i in range(calls):
                name = CELLS[(t + i) % len(CELLS)]
                x, buf, es = inputs[name]
                if not np.array_equal(decode(buf, es), x):
                    errors.append(f"thread {t} call {i} {name}")
        except Exception as exc:  # reported below, with the thread
            errors.append(f"thread {t}: {exc!r}")

    threads = [threading.Thread(target=work, args=(t,))
               for t in range(nthreads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"threads: {errors}")
    return {"threads": nthreads, "calls": nthreads * calls}


def timed(buf: bytes, es: int, reps: int) -> float:
    decode(buf, es)
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        decode(buf, es)
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def sweep(inputs, reps: int) -> dict:
    """A call's median ms at each segment count, both inputs in turns."""
    out = {}
    for segs in (1, 2, 3, 4, 6, 8, 12, 16):
        for name, (_, buf, es) in inputs.items():
            with constants(1, 1, segs):
                out[f"{name} segs {segs}"] = timed(buf, es, reps)
    return out


def sizes(inputs, reps: int) -> dict:
    """Each large input cut to a share of its rows: a call's median ms at
    the module's plan and at one segment, in turns."""
    out = {}
    for name, (x, full, es) in inputs.items():
        nd = read_metadata_rle(full)[2]
        for share in (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1 / 2):
            rows = int(x.size // nd * share) // 16 * 16
            buf = encoder.compress(x[:rows * nd], nd, codec="xff",
                                   device="cuda")
            ngroups = int.from_bytes(buf[:4], "little")
            plan = len(decoder.segment_plan("xff", ngroups, len(buf)))
            with constants(decoder.PIPE_BYTES, decoder.PIPE_GROUPS, 1):
                one = timed(buf, es, reps)
            key = f"{name} rows {rows} groups {ngroups} segs {plan}"
            out[key] = [timed(buf, es, reps), one]
    return out


STAGES = ("walk_headers", "gather_payloads", "upload_payload",
          "decode_device", "queue_download", "download_values", "_join")


def stage_ms(buf: bytes, es: int, segments: int, reps: int) -> dict:
    """Host ms a call in each of ``decompress``'s stages (the decoder's
    functions timed where it looks them up), at ``segments`` segments."""
    spent = dict.fromkeys(STAGES, 0.0)
    originals = {name: getattr(decoder, name) for name in STAGES}

    def timer(name, fn):
        def timed_fn(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t
        return timed_fn

    with constants(1, 1, segments):
        decode(buf, es)
        for name, fn in originals.items():
            setattr(decoder, name, timer(name, fn))
        try:
            t = time.perf_counter()
            for _ in range(reps):
                decode(buf, es)
            total = time.perf_counter() - t
        finally:
            for name, fn in originals.items():
                setattr(decoder, name, fn)
    out = {k: v * 1e3 / reps for k, v in spent.items()}
    out["call"] = total * 1e3 / reps
    return out


def profile(buf: bytes, es: int, segments: int, path: pathlib.Path) -> None:
    """torch.profiler over 5 calls at ``segments`` segments: its table by
    host self time, into ``path``."""
    from torch.profiler import ProfilerActivity, profile as prof_

    with constants(1, 1, segments):
        decode(buf, es)
        with prof_(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                decode(buf, es)
    path.write_text(prof.key_averages().table(
        sort_by="self_cpu_time_total", row_limit=30))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="the checks, without the sweeps")
    ap.add_argument("--stages", action="store_true",
                    help="the large inputs' host stages and a profile "
                    "only, their streams and tables written under --out")
    ap.add_argument("--out", default=str(ROOT / "build" / "pipe_probe"),
                    help="where --stages writes its files")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("pipe_probe: needs a CUDA card")
    rng = np.random.default_rng(SEED)
    res = {"card": card(), "torch": torch.__version__}
    if args.stages:
        outdir = pathlib.Path(args.out)
        outdir.mkdir(parents=True, exist_ok=True)
        for name, (_, buf, es) in large_inputs().items():
            (outdir / f"pipe_{name}.bin").write_bytes(buf)
            for segs in (1, 4, 12):
                res[f"{name} segs {segs}"] = stage_ms(buf, es, segs, 10)
                print(f"[pipe] {name} segs {segs}: "
                      + json.dumps(res[f"{name} segs {segs}"]), flush=True)
            profile(buf, es, 12, outdir / f"pipe_profile_{name}.txt")
        print(json.dumps(res), flush=True)
        return
    t = time.perf_counter()
    res["small_segments"] = check_small(rng)
    print(f"[pipe] small streams: {len(res['small_segments'])} decodes "
          f"equal the input ({time.perf_counter() - t:.1f} s)", flush=True)
    inputs = large_inputs()
    res["large_counters"] = check_large(inputs)
    print(f"[pipe] large: {json.dumps(res['large_counters'])}", flush=True)
    res["threads"] = check_threads(inputs)
    print(f"[pipe] threads: {res['threads']}", flush=True)
    if not args.quick:
        res["sweep_ms"] = sweep(inputs, reps=15)
        for k, v in res["sweep_ms"].items():
            print(f"[pipe] {k}: {v:.3f} ms", flush=True)
        res["sizes_ms"] = sizes(inputs, reps=15)
        for k, (plan, one) in res["sizes_ms"].items():
            print(f"[pipe] {k}: {plan:.3f} ms, one segment {one:.3f} ms",
                  flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
