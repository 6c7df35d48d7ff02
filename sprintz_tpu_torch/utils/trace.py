"""Tracing of the port: its spans and counters.

The reference's only tooling is an rdtsc timer (test/timing_utils.hpp).
Here:

- ``annotate``: a span of the program, a ``torch.profiler.record_function``
  range entered only while a profiler runs, as a context manager or a
  decorator. The codec's stages carry one each (``sprintz.compress``,
  ``decode.walk``, ``encode.assemble``, ...), inside the stage function,
  so every path through it has it. Spans land in the profiler's trace
  beside the card's kernels and copies, on the same clock, and under
  ``torch.autograd.profiler.emit_nvtx`` as NVTX ranges. With no profiler
  running a span costs a check of the profiler's state and nothing else:
  there is no switch to set.
- ``device_profile``: a ``torch.profiler`` trace of a code region (CUDA
  activity on a CUDA device), written as a Chrome trace into a directory
  (open it in Perfetto or ``chrome://tracing``).
- Counters: integer attributes of the port's functions, as the kernel
  wrappers count their launches (``launches``) and the host library's
  wrappers their calls (``calls``). ``count`` adds to them under any
  wrapper around the function, ``count_transfer`` counts the bytes of a
  copy to or from a CUDA device, pageable or pinned, and ``counters``
  reads them all at once.
"""

from __future__ import annotations

import contextlib
import functools
import sys

import torch

from ..device import resolve_device

PACKAGE = __name__.split(".")[0]

_profiling = torch.autograd._profiler_enabled


class annotate:
    """A span named ``name``: ``with annotate("decode.walk"): ...`` or
    ``@annotate("decode.walk")`` on a function. While a profiler runs
    (``torch.profiler.profile``, ``device_profile``, ``emit_nvtx``) it is a
    ``record_function`` range; otherwise it enters nothing. Spans nest by
    time on the calling thread: a call's stages lie inside its
    ``sprintz.*`` span. As a decorator it also counts the function's calls
    in its ``calls``."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            rng, self._range = self._range, None
            rng.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            fn.calls += 1
            if not _profiling():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        fn.calls = 0
        return spanned


@contextlib.contextmanager
def device_profile(logdir: str, device=None):
    """Profile a code region; yields the ``torch.profiler.profile``.

    ``device``: CUDA unless named (raises without it); on a CUDA device the
    trace holds the card's kernels and copies beside the host's operators
    and the program's spans, on ``"cpu"`` (tests) the host's alone. On exit
    the trace is written to ``logdir`` as ``<host>_<pid>.<ns>.pt.trace.json``
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


def _innermost(fn):
    """``fn`` under its wrappers (``functools.wraps``' ``__wrapped__``):
    the function whose attributes hold its counters."""
    while hasattr(fn, "__wrapped__"):
        fn = fn.__wrapped__
    return fn


def count(fn, **deltas: int) -> None:
    """Add ``deltas`` to the counters of the function ``fn``, found under
    any wrapper (a span's, a caller's); a counter starts at 0, so
    ``count(fn, name=0)`` declares one. Unlocked, as the launch counters
    are: threads counting into one counter at once may lose counts."""
    fn = _innermost(fn)
    for name, n in deltas.items():
        setattr(fn, name, getattr(fn, name, 0) + n)


def count_transfer(fn, device: torch.device, *host) -> None:
    """Count a copy between ``device`` and the host arrays or tensors
    ``host`` into ``fn``'s ``pinned_bytes`` (pinned tensors) and
    ``pageable_bytes`` (the rest, numpy arrays among them); nothing where
    ``device`` is not CUDA."""
    if torch.device(device).type != "cuda":
        return
    pinned = pageable = 0
    for h in host:
        if isinstance(h, torch.Tensor) and h.is_pinned():
            pinned += h.nbytes
        else:
            pageable += h.nbytes
    count(fn, pinned_bytes=pinned, pageable_bytes=pageable)


def _functions(mod):
    """(dotted name, function) of the module's own functions and of the
    methods of its own classes, each under its own name (not under an
    alias such as a loop's variable)."""
    for attr, obj in list(vars(mod).items()):
        if (getattr(obj, "__module__", None) != mod.__name__
                or getattr(obj, "__name__", None) != attr):
            continue
        if isinstance(obj, type):
            for name, meth in list(vars(obj).items()):
                if callable(meth) and getattr(meth, "__name__", None) == name:
                    yield f"{attr}.{name}", meth
        elif callable(obj):
            yield attr, obj


def counters() -> dict[str, int]:
    """Every counter of the port's imported modules, at this moment:
    ``{"<module>.<function>.<counter>": n, ...}`` with the module's name
    below the package (``"decoder.upload_payload.pageable_bytes"``,
    ``"ops.decode_kernels.unpack_zz.launches"``,
    ``"api.SprintzCodec.decompress.calls"``), and
    ``"native_host.threads_started"``, the threads the host library has
    started. The difference of two snapshots is what ran between them."""
    out = {}
    for modname, mod in sorted(sys.modules.items()):
        if mod is None or not modname.startswith(PACKAGE + "."):
            continue
        short = modname[len(PACKAGE) + 1:]
        for path, fn in _functions(mod):
            for name, v in getattr(_innermost(fn), "__dict__", {}).items():
                if type(v) is int and not name.startswith("_"):
                    out[f"{short}.{path}.{name}"] = v
    native = sys.modules.get(PACKAGE + ".native_host")
    if native is not None:
        out["native_host.threads_started"] = native.threads_started()
    return out
