"""The transfers' device time a encode call: every memcpy the profiler saw
on the card in the window (the rows' upload and the downloads of the
device pass's outputs), a call."""

E = "sprintz_tpu_torch.encoder."
LAYER = "transfers"
SOURCE = "device_trace"
MOVES = "encode_GBps"
WRAPS = (E + "upload_rows",)


def read(r):
    return r.device_ms("memcpy")
