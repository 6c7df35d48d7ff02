"""Spans from the benchmark's side: wrappers around the program's
functions, installed where their callers look them up.

A function is named by its dotted path, e.g.
``sprintz_tpu_torch.decoder.walk_headers`` (a module attribute) or
``sprintz_tpu_torch.api.SprintzCodec.decompress`` (a class attribute).
Each call of a wrapped function records a span: its name, start and end
on the host's monotonic clock (ns), and the span open around it. A
function named in ``sync`` closes its span only once the device has
finished what it queued (``sync_fn``), so that the wait for its work lands
in its own span and not in a caller's later download."""

from __future__ import annotations

import bisect
import dataclasses
import functools
import importlib
import time


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int
    parent: int  # index of the span open around it, -1 at the top

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


def _resolve(path: str):
    """Dotted path -> (owner object, attribute name); raises LookupError
    where no module prefix imports or an attribute is missing."""
    parts = path.split(".")
    for cut in range(len(parts) - 1, 0, -1):
        try:
            owner = importlib.import_module(".".join(parts[:cut]))
        except ImportError:
            continue
        for attr in parts[cut:-1]:
            owner = getattr(owner, attr, None)
            if owner is None:
                raise LookupError(f"{path}: no attribute {attr}")
        if not callable(getattr(owner, parts[-1], None)):
            raise LookupError(f"{path}: no function {parts[-1]}")
        return owner, parts[-1]
    raise LookupError(f"{path}: no module imports")


class Recorder:
    """Installs span wrappers and keeps the spans in memory."""

    def __init__(self):
        self.spans: list[Span] = []
        self.missing: dict[str, str] = {}  # path -> why it was not wrapped
        self._stack: list[int] = []
        self._undo: list[tuple[object, str, object]] = []

    def wrap(self, paths, sync=(), sync_fn=None) -> None:
        sync = set(sync) if sync_fn is not None else set()
        for path in dict.fromkeys(paths):
            try:
                owner, attr = _resolve(path)
            except LookupError as exc:
                self.missing[path] = str(exc)
                continue
            original = owner.__dict__.get(attr, getattr(owner, attr))
            setattr(owner, attr, self._wrapper(
                path, getattr(owner, attr),
                sync_fn if path in sync else None))
            self._undo.append((owner, attr, original))

    def _wrapper(self, name: str, fn, sync_fn):
        spans, stack = self.spans, self._stack

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            parent = stack[-1] if stack else -1
            stack.append(len(spans))
            spans.append(Span(name, time.perf_counter_ns(), 0, parent))
            try:
                out = fn(*args, **kwargs)
                if sync_fn is not None:
                    sync_fn()
                return out
            finally:
                spans[stack.pop()].end_ns = time.perf_counter_ns()
        return wrapped

    def clear(self) -> None:
        self.spans.clear()

    def restore(self) -> None:
        for owner, attr, original in reversed(self._undo):
            setattr(owner, attr, original)
        self._undo.clear()


def self_ms(spans: list[Span], entry: str, layer: set[str]) -> float:
    """Total time of the ``entry`` spans less the spans of other layers
    called from inside them: a child span counts where its chain up to the
    entry runs through ``layer``'s functions only."""
    total = sum(s.ms for s in spans if s.name == entry)
    for s in spans:
        if s.name in layer or s.parent < 0:
            continue
        p = s.parent
        while p >= 0 and spans[p].name in layer and spans[p].name != entry:
            p = spans[p].parent
        if p >= 0 and spans[p].name == entry:
            total -= s.ms
    return total


def innermost(spans: list[Span], starts: list[int], t_ns: int) -> str | None:
    """The name of the deepest span open at ``t_ns``; ``starts`` are the
    spans' start times, which rise with their order (spans nest, and each
    is recorded as it opens)."""
    i = bisect.bisect_right(starts, t_ns) - 1
    while i >= 0 and not spans[i].start_ns <= t_ns < spans[i].end_ns:
        i = spans[i].parent
    return spans[i].name if i >= 0 else None
