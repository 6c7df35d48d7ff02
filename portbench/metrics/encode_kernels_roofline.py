"""The encode kernels' share of their roofline: the least time a call's
work could take, each compressed and each uncompressed byte of the call
moved once at the card's memory bandwidth (`peaks.py`), over the
kernels' device time a call. The bytes come from the cell's sizes, not
from which kernels ran."""

E = "sprintz_tpu_torch.encoder."
LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "encode_GBps"
WRAPS = (E + "encode_device",)


def read(r):
    least, spent = r.least_ms(), r.device_ms("kernel")
    if least is None or spent is None:
        return None
    return 100.0 * least / spent
