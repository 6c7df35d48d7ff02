"""The host runtime's time an encode call: the emission plan and the
stream's assembly (`native_host.py` over `csrc/sprintz_host.cpp`)."""

E = "sprintz_tpu_torch.encoder."
LAYER = "host runtime"
SOURCE = "program_span"
MOVES = "encode_GBps"
WRAPS = (E + "build_plan", E + "assemble_stream")


def read(r):
    return r.span_ms(WRAPS)
