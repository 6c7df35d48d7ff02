"""The bytes the host itself copies a decode call, in MB (10^6): the dense
payload the gather writes (`decoder.gather_payloads`, `bytes`: every data
block's rows padded to the walk's widest) and the values and verbatim tail
the join writes into the returned array (`decoder._join`, `bytes`), as the
program counts them. A count a call over the warm-up's and the window's
calls (`portbench/counters.py`); nothing in a run without a device trace
(the harness's own runs on the CPU), nor from a program without the
counters."""

from portbench import counters

D = "decoder."
LAYER = "host runtime"
SOURCE = "program_counter"
MOVES = "decode_GBps"
WRAPS = ()
KEYS = (D + "gather_payloads.bytes", D + "_join.bytes")
CALLS = "api.SprintzCodec.decompress.calls"
START = counters.snapshot()


def read(r):
    if r.device is None:
        return None
    v = counters.per_call(START, counters.snapshot(), KEYS, CALLS)
    return None if v is None else v / 1e6
