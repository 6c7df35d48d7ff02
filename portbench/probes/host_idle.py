"""The program's own spans and counters over a cell's window, on the card:
the device's idle time under each host step, read on the profiler's clock.

    python3 -m portbench.probes.host_idle --workload <cell> --seed <n> \
        [--seconds 20] [--span-cost] [--nvtx]

The cell's set-up as ``run.py`` makes it (inputs, the entry's set-up, the
warm-up), then one window under ``torch.profiler`` (CPU and CUDA
activity) with the program's counters (``utils.trace.counters``) taken
inside the window's mark and after it. From the one trace: the card's
operations and idle stretches (``devtrace``), and the program's spans
(``sprintz.*``, ``decode.*``, ``encode.*``, ``huf.*``), whose times are on
the same clock. Prints one JSON line a call's averages:

- ``idle_host_ms``: the idle time inside the host steps' spans (the
  decode's ``decode.walk`` and ``decode.gather``, the encode's
  ``encode.plan`` and ``encode.assemble``), each gap cut exactly to each
  span; ``span_host_ms`` the same spans' own time, and ``host_ms`` the
  benchmark's ``host_ms.*`` in the same run (its wrappers' spans on the
  host's clock).
- ``idle_by_span``: every idle stretch charged, piece by piece, to the
  innermost program span open over it; ``outside`` where none is (the
  benchmark's loop), so the pieces add up to the window's idle time.
- ``midpoint_by_span``: each whole gap charged to the span open at its
  middle, as ``run.py``'s ``breakdown`` charges it (to the benchmark's
  wrappers there).
- ``counters``: the window's change of every counter that moved, a call;
  ``reckoned_pageable_MB``: the bytes a call's copies move, reckoned from
  the inputs' streams and arrays alone, beside ``pageable_MB`` counted.
- with ``--span-cost``: a span's cost on this host, off (no profiler) and
  on; with ``--nvtx``: whether the spans open under
  ``torch.autograd.profiler.emit_nvtx``.

On the machine with the card; ``--device cpu`` rehearses it on the CPU
(the kernels' plain versions, no device trace)."""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time

from .. import devtrace, loop, run
from ..spans import Recorder

PREFIXES = ("sprintz.", "decode.", "encode.", "huf.")
HOST_STEPS = {"decode": ("decode.walk", "decode.gather"),
              "encode": ("encode.plan", "encode.assemble")}


def marks(prof, lo: int, hi: int) -> list[tuple[int, int, str]]:
    """The program's spans on the host inside [lo, hi): (start, end, name),
    in the order they opened."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return sorted((max(e.start_ns(), lo), min(e.end_ns(), hi), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.is_user_annotation() and e.device_type() != cuda
                  and e.name().startswith(PREFIXES)
                  and e.end_ns() > lo and e.start_ns() < hi)


def overlap(a: int, b: int, c: int, d: int) -> int:
    return max(0, min(b, d) - max(a, c))


def idle_under(gaps, spans) -> int:
    """ns of the gaps inside the spans (which do not overlap each other)."""
    gaps, spans = sorted(gaps), sorted(spans)
    total, j = 0, 0
    for a, b in gaps:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            total += overlap(a, b, *spans[k][:2])
            k += 1
    return total


def innermost_segments(ms):
    """Spans that nest (one thread's) -> (start, end, name) pieces of the
    timeline, in order, each labelled with the innermost span open over
    it."""
    out, stack, cur = [], [], 0  # stack: (end, name) of the open spans

    def close(t):
        nonlocal cur
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > cur:
                out.append((cur, end, name))
                cur = end

    for a, b, name in sorted(ms, key=lambda m: (m[0], -m[1])):
        close(a)
        if stack and a > cur:
            out.append((cur, a, stack[-1][1]))
        cur = max(cur, a)
        stack.append((b, name))
    close(2 ** 63)
    return out


def charge_exact(gaps, segs) -> dict[str, float]:
    """Each gap's pieces to the innermost span over them (``segs``), s;
    ``outside`` where no span is open."""
    by: dict[str, float] = {}
    j = 0
    for a, b in gaps:
        inside = 0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            ov = overlap(a, b, segs[k][0], segs[k][1])
            by[segs[k][2]] = by.get(segs[k][2], 0.0) + ov / 1e9
            inside += ov
            k += 1
        by["outside"] = by.get("outside", 0.0) + (b - a - inside) / 1e9
    return by


def charge_midpoint(gaps, segs) -> dict[str, float]:
    """Each whole gap to the innermost span open at its middle, s."""
    starts = [s[0] for s in segs]
    by: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = segs[i][2] if i >= 0 and mid < segs[i][1] else "outside"
        by[name] = by.get(name, 0.0) + (b - a) / 1e9
    return by


def reckoned_bytes(direction: str, config: dict, inputs, prepared) -> list:
    """Each input's bytes over the bus a call, from its stream's walk and
    its array's shape alone: the decode's payload, widths and first rows up
    and values down; the encode's rows up and widths, headers, payload and
    width sums down."""
    from sprintz_tpu_torch import decoder
    from sprintz_tpu_torch.constants import BLOCK_SZ, LOWDIM_MAX_NDIMS
    from sprintz_tpu_torch.stream_format import read_metadata_rle

    es, d = config["elem_sz"], config["ndims"]
    lowdim = d <= LOWDIM_MAX_NDIMS[es]
    out = []
    for k, x in enumerate(inputs):
        if direction == "decode":
            buf = prepared.state[k]
            ngroups, _, nd = read_metadata_rle(buf)
            idx = decoder.walk_headers(buf, ngroups, nd, es, lowdim)
            ndata = idx.widths.shape[0]
            inner = (d * 8 * es if lowdim
                     else BLOCK_SZ * decoder.stream_maxb(idx))
            out.append(ndata * inner + ndata * d + ndata * 8
                       + idx.total_rows * d * es)
        else:
            nb = x.shape[0] // BLOCK_SZ
            out.append(nb * BLOCK_SZ * d * es + 2 * nb * d
                       + nb * BLOCK_SZ * d * es + 4 * nb)
    return out


def span_cost(n: int = 100_000) -> dict:
    """µs a span costs on this host: as a context manager and as a
    decorator, with no profiler and under one (CPU activity)."""
    import torch

    from sprintz_tpu_torch.utils import trace

    @trace.annotate("probe.decorated")
    def f():
        pass

    def timed(body):
        t = time.perf_counter()
        body()
        return (time.perf_counter() - t) / n * 1e6

    def ctx():
        for _ in range(n):
            with trace.annotate("probe.context"):
                pass

    def dec():
        for _ in range(n):
            f()

    def bare():
        for _ in range(n):
            pass

    out = {"loop_us": timed(bare), "off_context_us": timed(ctx),
           "off_decorator_us": timed(dec)}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out["on_context_us"] = timed(ctx)
        out["on_decorator_us"] = timed(dec)
    return out


def nvtx_check() -> dict:
    """Whether the spans open under ``emit_nvtx`` (their gate reads the
    profiler's state, which ``emit_nvtx`` sets)."""
    import torch

    from sprintz_tpu_torch.utils import trace

    seen = []
    real = torch.profiler.record_function

    def spy(name, args=None):
        seen.append(name)
        return real(name, args)

    torch.profiler.record_function = spy
    try:
        with torch.autograd.profiler.emit_nvtx():
            enabled = torch.autograd._profiler_enabled()
            with trace.annotate("probe.nvtx"):
                pass
    finally:
        torch.profiler.record_function = real
    return {"gate_open": enabled, "spans_entered": seen}


def main(argv=None, *, _device=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.probes.host_idle")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--span-cost", action="store_true")
    ap.add_argument("--nvtx", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    manifest = json.loads(run.MANIFEST.read_text())
    cell = {w["name"]: w for w in manifest["workloads"]}[args.workload]
    config = loop.load_config(cell["config"])
    mix = loop.load_traffic(cell["traffic"])
    direction = "encode" if mix.params["entry"] == "compress" else "decode"

    import torch

    rec = Recorder()
    rec.wrap(run.load_metric(f"host_ms.{direction}").WRAPS)
    try:
        return _probe(args, config, mix, direction, torch, rec)
    finally:
        rec.restore()


def _probe(args, config, mix, direction, torch, rec) -> int:
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        run.say("no CUDA device")
        return 3
    import sprintz_tpu_torch as port
    from sprintz_tpu_torch.utils import trace

    device = None if cuda else "cpu"
    inputs = loop.make_inputs(config, mix.params, args.seed)
    codec = port.SprintzCodec(config["codec"], config["elem_sz"],
                              entropy=config["entropy"], device=device)
    prepared = mix.entry.prepare(codec, inputs)
    for _ in range(mix.params["warmup_rounds"]):
        for a in prepared.args:
            prepared.call(a)
    if cuda:
        torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    rec.clear()
    with profile(activities=acts) as prof:
        with record_function(devtrace.WINDOW_MARK):
            before = trace.counters()
            win = mix.loop.run(prepared.call, prepared.args, args.seconds,
                               mix.params, args.seed)
        after = trace.counters()
    calls = win.calls
    window = (devtrace.reduce(prof) if cuda else None)
    lo, hi = ((window.window_start_ns, window.window_end_ns) if window
              else (0, 2 ** 63))
    ms = marks(prof, lo, hi)
    out = {"workload": args.workload, "seed": args.seed, "calls": calls,
           "card": run.power_limit() if cuda else None,
           "torch": torch.__version__}
    steps = [m[:2] for m in ms if m[2] in HOST_STEPS[direction]]
    out["span_host_ms"] = sum(b - a for a, b in steps) / 1e6 / calls
    out["host_ms"] = sum(sp.ms for sp in rec.spans) / calls
    tops = [m for m in ms if m[2].startswith("sprintz.")]
    out["top_spans"] = len(tops)
    if window is not None:
        gaps = window.gaps()
        segs = innermost_segments(ms)
        out["window_s"] = window.window_s
        out["idle_ms"] = sum(b - a for a, b in gaps) / 1e6 / calls
        out["idle_host_ms"] = idle_under(gaps, steps) / 1e6 / calls
        out["idle_by_span"] = {k: v * 1e3 / calls for k, v in sorted(
            charge_exact(gaps, segs).items(), key=lambda kv: -kv[1])}
        out["midpoint_by_span"] = {k: v * 1e3 / calls for k, v in sorted(
            charge_midpoint(gaps, segs).items(), key=lambda kv: -kv[1])}
        out["kernel_ms"] = window.seconds("kernel") * 1e3 / calls
        out["copy_ms"] = window.seconds("memcpy") * 1e3 / calls
        out["device_ops_with_span_names"] = sorted(
            {o.name for o in window.ops if o.name.startswith(PREFIXES)})
    moved = {k: (after[k] - before.get(k, 0)) / calls for k in after
             if after[k] != before.get(k, 0)}
    out["counters"] = moved
    pageable = sum(v for k, v in moved.items()
                   if k.endswith(".pageable_bytes"))
    out["pageable_MB"] = pageable / 1e6
    per_input = reckoned_bytes(direction, config, inputs, prepared)
    out["reckoned_pageable_MB"] = sum(
        per_input[k] for k in win.inputs_used) / calls / 1e6
    out["reckoned_per_input_MB"] = [b / 1e6 for b in per_input]
    del prof
    if args.span_cost:
        out["span_cost"] = span_cost()
    if args.nvtx and cuda:
        out["nvtx"] = nvtx_check()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
