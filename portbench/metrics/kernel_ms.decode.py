"""The kernels' device time a decode call: every kernel the profiler saw on
the card in the window (`csrc/fire.cu`, `decode.cu`, `pack.cu` through
`ops/`, and PyTorch's own), a call."""

D = "sprintz_tpu_torch.decoder."
LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "decode_GBps"
WRAPS = (D + "decode_device",)


def read(r):
    return r.device_ms("kernel")
