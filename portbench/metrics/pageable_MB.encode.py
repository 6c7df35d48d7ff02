"""The pageable bytes that cross the bus an encode call, in MB (10^6): the
rows' upload (`encoder.upload_rows`) and the downloads of the device
pass's widths, headers, payload and width sums (`download_outputs`), as
the program counts them (`pageable_bytes`, on a CUDA device only). A count
a call over the warm-up's and the window's calls (`portbench/counters.py`);
nothing in a run without a device trace (the harness's own runs on the
CPU), nor from a program without the counters."""

from portbench import counters

E = "encoder."
LAYER = "transfers"
SOURCE = "program_counter"
MOVES = "encode_GBps"
WRAPS = ()
KEYS = tuple(E + f + ".pageable_bytes"
             for f in ("upload_rows", "download_outputs"))
CALLS = "api.SprintzCodec.compress.calls"
START = counters.snapshot()


def read(r):
    if r.device is None:
        return None
    v = counters.per_call(START, counters.snapshot(), KEYS, CALLS)
    return None if v is None else v / 1e6
