"""The fresh host memory a decode call's result takes, in MB (10^6): the
bytes of the blocks that `decoder._room` allocates anew (`fresh_bytes`)
rather than recycles from the output pool (`recycled_bytes`), whose pages
are mapped already. A count a call over the warm-up's and the window's
calls (`portbench/counters.py`); the answers the comparison keeps hold
their blocks to the window's end, so those calls take fresh ones. Nothing
in a run without a device trace (the harness's own runs on the CPU), nor
from a program without the counter (one without the pool)."""

from portbench import counters

LAYER = "API"
SOURCE = "program_counter"
MOVES = "decode_GBps"
WRAPS = ()
KEYS = ("decoder._room.fresh_bytes",)
CALLS = "api.SprintzCodec.decompress.calls"
START = counters.snapshot()


def read(r):
    if r.device is None:
        return None
    v = counters.per_call(START, counters.snapshot(), KEYS, CALLS)
    return None if v is None else v / 1e6
