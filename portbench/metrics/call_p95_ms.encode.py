"""The 95th percentile of an encode call's time, from the spans of
`SprintzCodec.compress` in a traced run: the call's tail where the host's
steps make it too unsteady between runs to hold `p95_ms` to a bound (the
row-major encode, whose assembly and plan run on the host's threads).
In traced runs the cell's other readers close the device pass's span on a
sync, which the call waits for in any case."""

import statistics

E = "sprintz_tpu_torch.encoder."
LAYER = "API"
SOURCE = "program_span"
MOVES = "encode_GBps"
ENTRY = "sprintz_tpu_torch.api.SprintzCodec.compress"
WRAPS = (ENTRY,)


def read(r):
    if not r.has(WRAPS):
        return None
    ms = [s.ms for s in r.spans if s.name == ENTRY and s.parent < 0]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
