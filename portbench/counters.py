"""The program's own counters (``sprintz_tpu_torch.utils.trace.counters``),
for the readers that take a metric from them.

A reader takes a snapshot as the harness loads it, before the set-up's
warm-up, and another as it reads, after the window: the difference, over
the calls of the entry point counted between the two, is a count a call
over the warm-up's and the window's calls alike (each input's calls move
the same counts, and the warm-up is two rounds over the inputs to the
window's thousands of calls). A program without the counters (one older
than them) gives no snapshot, and its readers read nothing."""

from __future__ import annotations


def snapshot() -> dict | None:
    """The program's counters now; None where it has no ``counters``."""
    from sprintz_tpu_torch.utils import trace

    read = getattr(trace, "counters", None)
    return None if read is None else read()


def per_call(before: dict | None, after: dict | None, keys, calls: str
             ) -> float | None:
    """The summed change of ``keys`` between two snapshots, over the change
    of the counter ``calls``; None where a snapshot or a counter is
    missing, or no call was counted."""
    if before is None or after is None:
        return None
    if any(k not in after for k in (*keys, calls)):
        return None
    n = after[calls] - before.get(calls, 0)
    if n <= 0:
        return None
    return sum(after[k] - before.get(k, 0) for k in keys) / n
