"""The delta decode's kernels' share of their roofline: the least time a
call's work could take, each compressed and each uncompressed byte of the
call moved once at the card's memory bandwidth (`Reading.least_ms`,
`peaks.py`), over the device time a call of the delta pass's own kernels,
K1 and K2 (`csrc/decode.cu`: the operations whose names hold
`unpack_zz_kernel` or `prefix_finish_kernel`). `place_blocks`' PyTorch
kernels, copies and memsets are left out. For delta cells only: FIRE's
K4 and K5 are instantiations of K1's template. Nothing where no such
kernel ran, or without a device trace."""

LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "decode_GBps"
WRAPS = ()
KERNELS = ("unpack_zz_kernel", "prefix_finish_kernel")


def read(r):
    least = r.least_ms()
    if least is None or r.device is None or not r.calls:
        return None
    ns = sum(o.end_ns - o.start_ns for o in r.device.ops
             if o.kind == "kernel" and any(k in o.name for k in KERNELS))
    if ns <= 0:
        return None
    return 100.0 * least / (ns / 1e6 / r.calls)
