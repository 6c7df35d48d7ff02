"""The host runtime's time a decode call: the header walk and the payload
gather (`native_host.py` over `csrc/sprintz_host.cpp`)."""

D = "sprintz_tpu_torch.decoder."
LAYER = "host runtime"
SOURCE = "program_span"
MOVES = "decode_GBps"
WRAPS = (D + "walk_headers", D + "gather_payloads")


def read(r):
    return r.span_ms(WRAPS)
