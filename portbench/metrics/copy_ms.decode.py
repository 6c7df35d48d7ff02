"""The transfers' device time a decode call: every memcpy the profiler saw
on the card in the window (the payload's upload and the values'
download), a call."""

D = "sprintz_tpu_torch.decoder."
LAYER = "transfers"
SOURCE = "device_trace"
MOVES = "decode_GBps"
WRAPS = (D + "upload_payload", D + "download_values")


def read(r):
    return r.device_ms("memcpy")
