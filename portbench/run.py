"""One run of one cell of ``BENCHMARK.json``.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. A cell is
``<config>.<traffic>``: ``configs/<config>.json`` is the deployment (the
profile of the data, its rows, dims, element size, codec and entropy
stage), ``traffic/<traffic>.json`` the mix (``loop.py`` reads it; it
names its entry, ``entries/<entry>.py``, and its loop,
``loops/<loop>.py``), and each per-layer metric is a reader
``metrics/<name>.py``, all found by name.

In order: set-up (the port's import, the inputs from the seed, what the
entry makes of them, a warm-up over every input), the loop's window of
``--seconds``, the comparison with the frozen reference (``check.py`` and
the entry's), and one JSON line on standard output. With
``--trace 1`` the port's functions that the cell's metric readers name
are wrapped in spans and ``torch.profiler`` records the window; the line
then carries the per-layer metrics instead of the end-to-end ones.

Without a CUDA card (or with fewer cards than the cell asks for), without
the port beside it, or with JAX or the JAX package loaded once the window
has closed, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import check, devtrace, loop, peaks  # noqa: E402
from .reading import Reading  # noqa: E402
from .spans import Recorder, innermost  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
MANIFEST = HERE.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "sprintz_tpu")
PORT = "sprintz_tpu_torch"


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_metric(name: str):
    """``metrics/<name>.py`` as a module."""
    return loop.load_part("metrics", name)


def for_cell(metrics: list[dict], cell: str) -> list[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def breakdown(dev: devtrace.DeviceTrace, spans, host_t0_ns: int) -> dict:
    """The device's ten costliest operations by name, and its idle time by
    the benchmark span open on the host at each gap's middle."""
    by_op: dict[str, float] = {}
    for o in dev.ops:
        by_op[o.name] = by_op.get(o.name, 0.0) + (o.end_ns - o.start_ns) / 1e9
    starts = [s.start_ns for s in spans]
    by_span: dict[str, float] = {}
    for a, b in dev.gaps():
        mid = (a + b) // 2 - dev.window_start_ns + host_t0_ns
        name = innermost(spans, starts, mid)
        label = name.removeprefix(PORT + ".") if name else "harness"
        by_span[label] = by_span.get(label, 0.0) + (b - a) / 1e9

    def top(d):
        return [[k[:200], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_span)}


def main(argv=None, *, _device=None, _codec=None) -> int:
    """The run; returns the exit code. ``_device`` and ``_codec`` exist for
    the benchmark's own tests: ``_device="cpu"`` puts the port on the CPU
    (its kernels' plain versions), and ``_codec(config)`` puts another
    codec in the port's place (the comparison's control)."""
    args = parse(argv)
    try:
        manifest = json.loads(MANIFEST.read_text())
    except (OSError, ValueError) as exc:
        say(f"no benchmark manifest: {exc}")
        return 2
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        say(f"unknown workload {args.workload!r}")
        return 2
    cell = cells[args.workload]
    config = loop.load_config(cell["config"])
    mix = loop.load_traffic(cell["traffic"])

    import torch

    if _device is None:
        if not torch.cuda.is_available():
            say("no CUDA device: the benchmark runs on the card only")
            return 3
        if torch.cuda.device_count() < cell["chips"]:
            say(f"{torch.cuda.device_count()} CUDA devices, the cell asks "
                f"for {cell['chips']}")
            return 3
    if _device is None:
        torch.cuda.init()
    t_torch = time.perf_counter()
    try:
        port = importlib.import_module(PORT)
    except ImportError as exc:
        say(f"the port {PORT} does not import: {exc}")
        return 4
    say(f"set-up: torch and the card {t_torch - T_START:.3f} s, the port "
        f"{time.perf_counter() - t_torch:.3f} s")

    rec = None
    readers = []
    if args.trace:
        readers = [(m, load_metric(m["name"]))
                   for m in for_cell(manifest["per_layer"], args.workload)]
        rec = Recorder()
        rec.wrap((p for _, mod in readers for p in mod.WRAPS),
                 sync=[p for _, mod in readers
                       for p in getattr(mod, "SYNC", ())],
                 sync_fn=torch.cuda.synchronize if _device is None else None)
        for path, why in rec.missing.items():
            say(f"not wrapped, its metrics read null: {why}")

    try:
        return _run(args, cell, config, mix, manifest, torch, port, rec,
                    readers, _device, _codec)
    finally:
        if rec is not None:
            rec.restore()


def _run(args, cell, config, mix, manifest, torch, port, rec, readers,
         device, codec_factory) -> int:
    cuda = device is None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    params = mix.params
    t = time.perf_counter()
    inputs = loop.make_inputs(config, params, args.seed)
    t_inputs = time.perf_counter() - t
    if codec_factory is None:
        codec = port.SprintzCodec(config["codec"], config["elem_sz"],
                                  entropy=config["entropy"], device=device)
    else:
        codec = codec_factory(config)
    t = time.perf_counter()
    prepared = mix.entry.prepare(codec, inputs)
    call, calls_take = prepared.call, prepared.args
    t_prep = time.perf_counter() - t
    for _ in range(params["warmup_rounds"]):
        for a in calls_take:
            call(a)
    say(f"set-up: inputs {t_inputs:.3f} s, the entry's {t_prep:.3f} s, "
        f"warm-up {time.perf_counter() - t - t_prep:.3f} s")
    compressed = prepared.compressed
    say(f"set-up: compressed bytes {compressed} of "
        f"{[x.nbytes for x in inputs]}")
    if cuda:
        torch.cuda.synchronize()
    gc.collect()

    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)
        prof.__enter__()
        rec.clear()
        with record_function(devtrace.WINDOW_MARK):
            host_t0_ns = time.perf_counter_ns()
            win = mix.loop.run(call, calls_take, args.seconds, params,
                               args.seed)
        prof.__exit__(None, None, None)
    else:
        win = mix.loop.run(call, calls_take, args.seconds, params, args.seed)
    setup_s = win.start - T_START
    window_s = win.end - win.start
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0

    sizes = [x.nbytes for x in inputs]
    work = sum(sizes[k] for k in win.inputs_used)
    rate = work / window_s / 1e9
    lat_ms = [t * 1e3 for t in win.latencies]
    p95 = (statistics.quantiles(lat_ms, n=100, method="inclusive")[94]
           if len(lat_ms) > 1 else lat_ms[0])
    say(f"calls {win.calls} failed {win.failed} window_s {window_s!r} "
        f"{params['rate_metric']} {rate!r} p95_ms {p95!r} "
        f"median_ms {statistics.median(lat_ms)!r} setup_s {setup_s!r}"
        + (" (traced)" if args.trace else ""))
    if win.first_error:
        say("first failed call:\n" + win.first_error)

    device_info = {"platform": "gpu" if cuda else device,
                   "kind": torch.cuda.get_device_name(0) if cuda else device,
                   "count": cell["chips"], "memory_peak_bytes": mem_peak}
    metrics = {}
    extra = {}
    if args.trace:
        dev = devtrace.reduce(prof) if cuda else None
        del prof
        n = win.calls
        reading = Reading(
            spans=list(rec.spans), calls=n, device=dev,
            uncompressed_bytes=work / n,
            compressed_bytes=sum(compressed[k] for k in win.inputs_used) / n,
            peaks=peaks.PEAKS.get(device_info["kind"]),
            missing=set(rec.missing))
        for m, mod in readers:
            value = mod.read(reading)
            if value is None:
                say(f"metric {m['name']}: nothing to read, left out")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if dev is not None:
            device_info["busy_s"] = dev.busy_s()
            device_info["window_s"] = dev.window_s
            extra["breakdown"] = breakdown(dev, reading.spans, host_t0_ns)
    else:
        measured = {params["rate_metric"]: rate, "p95_ms": p95,
                    "setup_s": setup_s}
        for m in for_cell(manifest["end_to_end"], args.workload):
            if m["name"] not in measured:
                say(f"end-to-end metric {m['name']} is not measured here")
                return 6
            metrics[m["name"]] = {"value": measured[m["name"]],
                                  "unit": m["unit"]}
    if cuda:
        card = power_limit()
        if card:
            say(f"card {card}")

    # the program's state goes before the reference runs
    del call, codec
    prepared.call = None
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = check.compare(mix, config, inputs, prepared, win)
    say(f"comparison {time.perf_counter() - t:.3f} s")
    say(f"answers_checked {len(win.kept)}")
    correct = all(v <= lim for _, v, lim in checks)

    found = forbidden_modules()
    if found:
        say("loaded in the run's process: " + ", ".join(found))
        return 5
    for name, v, lim in checks:
        say(f"check {name} {v} limit {lim}")
    result = {"correct": correct, "attempted": win.calls,
              "failed": win.failed, "metrics": metrics,
              "device": device_info, **extra,
              "checks": {name: {"value": v, "limit": lim}
                         for name, v, lim in checks}}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
