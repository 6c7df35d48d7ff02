"""The device's side of a traced run: ``torch.profiler`` with CPU and CUDA
activity over the measured window, reduced in memory to the device's
operations (kernels, copies, memsets) inside the window.

The window is a ``record_function`` range opened as the window starts; its
start ties the host's clock, on which the benchmark's spans are taken, to
the profiler's."""

from __future__ import annotations

import dataclasses

WINDOW_MARK = "portbench.window"


@dataclasses.dataclass
class DeviceOp:
    name: str
    kind: str  # "kernel", "memcpy" or "memset"
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class DeviceTrace:
    ops: list[DeviceOp]  # inside the window, on the profiler's clock
    window_start_ns: int
    window_end_ns: int

    @property
    def window_s(self) -> float:
        return (self.window_end_ns - self.window_start_ns) / 1e9

    def seconds(self, kind: str) -> float:
        return sum(o.end_ns - o.start_ns for o in self.ops
                   if o.kind == kind) / 1e9

    def busy(self) -> list[tuple[int, int]]:
        """The union of the operations' intervals, in order."""
        out: list[list[int]] = []
        for o in sorted(self.ops, key=lambda o: o.start_ns):
            if out and o.start_ns <= out[-1][1]:
                out[-1][1] = max(out[-1][1], o.end_ns)
            else:
                out.append([o.start_ns, o.end_ns])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e9

    def gaps(self) -> list[tuple[int, int]]:
        """The window's stretches with no operation on the device."""
        out, t = [], self.window_start_ns
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.window_end_ns > t:
            out.append((t, self.window_end_ns))
        return out


def _kind(name: str, activity: str) -> str:
    text = (activity + " " + name).lower()
    if "memcpy" in text:
        return "memcpy"
    if "memset" in text:
        return "memset"
    return "kernel"


def reduce(prof) -> DeviceTrace | None:
    """A finished ``torch.profiler.profile`` -> its device operations
    inside the window mark; None where the trace has no window mark."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    mark, raw = None, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.is_user_annotation():
            if name == WINDOW_MARK and e.device_type() != cuda:
                mark = (e.start_ns(), e.end_ns())
            continue
        if e.device_type() == cuda:
            activity = getattr(e, "activity_type", "")
            activity = str(activity() if callable(activity) else activity)
            raw.append(DeviceOp(name, _kind(name, activity), e.start_ns(),
                                e.end_ns()))
    if mark is None:
        return None
    lo, hi = mark
    ops = [DeviceOp(o.name, o.kind, max(o.start_ns, lo), min(o.end_ns, hi))
           for o in raw if o.end_ns > lo and o.start_ns < hi]
    return DeviceTrace(ops, lo, hi)
