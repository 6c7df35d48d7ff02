"""The pageable bytes that cross the bus a decode call, in MB (10^6): the
payload's, the widths' and the rows' uploads (`decoder.upload_payload`,
`upload_batch`) and the values' download (`download_values`), as the
program counts them (`pageable_bytes`, on a CUDA device only). A count a
call over the warm-up's and the window's calls (`portbench/counters.py`);
nothing in a run without a device trace (the harness's own runs on the
CPU), nor from a program without the counters."""

from portbench import counters

D = "decoder."
LAYER = "transfers"
SOURCE = "program_counter"
MOVES = "decode_GBps"
WRAPS = ()
KEYS = tuple(D + f + ".pageable_bytes"
             for f in ("upload_payload", "upload_batch", "download_values"))
CALLS = "api.SprintzCodec.decompress.calls"
START = counters.snapshot()


def read(r):
    if r.device is None:
        return None
    v = counters.per_call(START, counters.snapshot(), KEYS, CALLS)
    return None if v is None else v / 1e6
