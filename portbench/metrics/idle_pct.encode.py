"""The device's idle share in a encode cell: the part of the traced window
in which no kernel, copy or memset ran on the card."""

LAYER = "device"
SOURCE = "device_trace"
MOVES = "encode_GBps"
WRAPS = ()


def read(r):
    return r.idle_pct()
