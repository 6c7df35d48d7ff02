"""The kernels' device time a encode call: every kernel the profiler saw on
the card in the window (`csrc/fire.cu`, `decode.cu`, `pack.cu` through
`ops/`, and PyTorch's own), a call."""

E = "sprintz_tpu_torch.encoder."
LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "encode_GBps"
WRAPS = (E + "encode_device",)


def read(r):
    return r.device_ms("kernel")
