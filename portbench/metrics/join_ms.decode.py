"""The join's time a decode call: `decoder._join`'s span less the
`download_values` span inside it, which waits for the values' copy to
land. What is left is the host's copy of each segment's values, and of
the verbatim tail, into the array the call returns. Wrapping `_join`
takes its time out of `api_self_ms.decode` in the cells that read this."""

D = "sprintz_tpu_torch.decoder."
LAYER = "API"
SOURCE = "program_span"
MOVES = "decode_GBps"
JOIN = D + "_join"
WRAPS = (JOIN, D + "download_values")


def read(r):
    return r.self_ms(JOIN, (JOIN,)) if r.has(WRAPS) else None
