"""Tracing / profiling utilities.

Counterpart of ``sprintz_tpu/utils/trace.py``. The reference's only
tooling is an rdtsc timer (test/timing_utils.hpp). Here:

- ``Timer``: wall-clock section timing with a structured report (the
  EasyTimer analogue), the JAX package's copy.
- ``device_profile``: a ``torch.profiler`` trace of a code region (CUDA
  activity on a CUDA device), written as a Chrome trace into a directory
  (open it in Perfetto or ``chrome://tracing``).
- ``annotate``: a named range inside such traces
  (``torch.profiler.record_function``), and an NVTX range where CUDA is
  present.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

from ..device import resolve_device


class Timer:
    """Accumulating section timer (EasyTimer analogue, timing_utils.hpp:60)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{name:30s} {self.totals[name] * 1e3:10.2f} ms "
                 f"({self.counts[name]}x)"
                 for name in sorted(self.totals, key=self.totals.get,
                                    reverse=True)]
        return "\n".join(lines)


@contextlib.contextmanager
def device_profile(logdir: str, device=None):
    """Profile a code region; yields the ``torch.profiler.profile``.

    ``device``: CUDA unless named (raises without it); on a CUDA device the
    trace holds the card's kernels and copies beside the host's operators,
    on ``"cpu"`` (tests) the host's alone. On exit the trace is written to
    ``logdir`` as ``<host>_<pid>.<ns>.pt.trace.json``
    (``torch.profiler.tensorboard_trace_handler``), and the profiler's
    ``key_averages()`` stay readable."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(logdir))) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


@contextlib.contextmanager
def annotate(name: str):
    """Named range visible in device traces (and NVTX, where CUDA is)."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
