"""What a per-layer metric's reader reads: the spans the benchmark took
around the program's functions, the device's operations from the
profiler, the calls of the window and the cell's sizes."""

from __future__ import annotations

import dataclasses

from .devtrace import DeviceTrace
from .spans import Span, self_ms


@dataclasses.dataclass
class Reading:
    spans: list[Span]  # the window's, on the host's clock
    calls: int  # calls in the window
    device: DeviceTrace | None  # None where the trace has no window
    uncompressed_bytes: float  # a call's, on average over the window
    compressed_bytes: float
    peaks: dict | None  # the card's row of ``peaks.PEAKS``
    missing: set[str]  # functions that could not be wrapped

    def has(self, paths) -> bool:
        return not self.missing.intersection(paths)

    def span_ms(self, paths) -> float | None:
        """The named functions' time a call, from their spans."""
        if not self.has(paths) or not self.calls:
            return None
        names = set(paths)
        return sum(s.ms for s in self.spans if s.name in names) / self.calls

    def self_ms(self, entry: str, layer) -> float | None:
        """The entry's time a call, less what other layers' functions took
        inside it (``spans.self_ms``)."""
        if not self.has(set(layer) | {entry}) or not self.calls:
            return None
        return self_ms(self.spans, entry, set(layer)) / self.calls

    def device_ms(self, kind: str) -> float | None:
        """Device time a call of the operations of one kind; None where
        the trace shows none."""
        if self.device is None or not self.calls:
            return None
        t = self.device.seconds(kind)
        return t * 1e3 / self.calls if t > 0 else None

    def idle_pct(self) -> float | None:
        if self.device is None or not self.device.ops:
            return None
        return 100.0 * (1.0 - self.device.busy_s() / self.device.window_s)

    def least_ms(self) -> float | None:
        """The least time a call's work could take on the card: each
        compressed and each uncompressed byte moved once at the card's
        memory bandwidth."""
        if not self.peaks:
            return None
        return ((self.uncompressed_bytes + self.compressed_bytes)
                / self.peaks["hbm_bytes_per_s"] * 1e3)
