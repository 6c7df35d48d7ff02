"""The threads the host runtime starts an encode call: `parallel_for`'s in
`csrc/sprintz_host.cpp`, counted by the program against the entry point
that started them (`native_host.assemble_stream`, `threads`; the plan takes
none). A count a call over the warm-up's and the window's calls
(`portbench/counters.py`); it depends on the host's cores. Nothing in a
run without a device trace (the harness's own runs on the CPU), nor from
a program without the counters."""

from portbench import counters

LAYER = "host runtime"
SOURCE = "program_counter"
MOVES = "encode_GBps"
WRAPS = ()
KEYS = ("native_host.assemble_stream.threads",
        "native_host.build_plan.threads")
CALLS = "api.SprintzCodec.compress.calls"
START = counters.snapshot()


def read(r):
    if r.device is None:
        return None
    return counters.per_call(START, counters.snapshot(), KEYS, CALLS)
