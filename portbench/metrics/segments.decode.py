"""The segments a decode call runs in: `decoder.decompress`'s pipeline
(`segment_plan`, the program's counter `segments`), 1 where the stream
decodes in one pass. A count a call over the warm-up's and the window's
calls (`portbench/counters.py`); nothing in a run without a device trace
(the harness's own runs on the CPU), nor from a program without the
counter."""

from portbench import counters

LAYER = "API"
SOURCE = "program_counter"
MOVES = "decode_GBps"
WRAPS = ()
KEYS = ("decoder.decompress.segments",)
CALLS = "api.SprintzCodec.decompress.calls"
START = counters.snapshot()


def read(r):
    if r.device is None:
        return None
    return counters.per_call(START, counters.snapshot(), KEYS, CALLS)
