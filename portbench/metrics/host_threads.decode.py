"""The threads the host runtime starts a decode call: `parallel_for`'s in
`csrc/sprintz_host.cpp`, counted by the program against the entry points
that started them (`native_host`'s walk split at checkpoints and its two
gathers, `threads`). A count a call over the warm-up's and the window's
calls (`portbench/counters.py`); it depends on the host's cores. Nothing in
a run without a device trace (the harness's own runs on the CPU), nor
from a program without the counters."""

from portbench import counters

LAYER = "host runtime"
SOURCE = "program_counter"
MOVES = "decode_GBps"
WRAPS = ()
KEYS = tuple("native_host." + f + ".threads"
             for f in ("walk_headers_parallel", "gather_blocks",
                       "gather_dims"))
CALLS = "api.SprintzCodec.decompress.calls"
START = counters.snapshot()


def read(r):
    if r.device is None:
        return None
    return counters.per_call(START, counters.snapshot(), KEYS, CALLS)
