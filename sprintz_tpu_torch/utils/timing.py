"""Device timing: seconds per call of a callable, over a loop of calls.

Counterpart of ``sprintz_tpu/utils/timing.py``. The JAX package runs the
kernel in an on-device ``fori_loop``, so that per-call dispatch does not
count. PyTorch has no such loop; here the calls are queued back to back
while the card is held busy (``torch.cuda._sleep``, a spin of about twice
the host's time to queue them), so that CUDA events around the loop time
the card's work and not the host's queueing: dispatch-free, as there. On
the CPU a host clock (``time.perf_counter``) brackets the loop. The
argument at index ``vary`` has its first element flipped in place before
each call (``^= i & 1``, as the JAX loop perturbs its carry), so no call
can reuse another's result; the element is put back afterwards. The loop
ends with a synchronize. A callable that reads from the card waits for it
at each read, and then the host's time counts too.
"""

from __future__ import annotations

import time

import torch

SPIN_HZ = 2.0e9  # cycles a second for the spin: above an H100's SM clock


def device_loop_time(kernel, args, iters: int = 16, vary: int = 0) -> float:
    """Seconds per call of ``kernel(*args)`` over ``iters`` calls timed
    together, after a warm-up call and a call that times the host's
    queueing. ``args[vary]`` must be an integer tensor (its first element
    is perturbed, then restored); the others are passed as they are. The
    device is ``args[vary]``'s."""
    args = list(args)
    arr = args[vary]
    flat = arr.view(-1)
    first = flat[:1].clone()
    cuda = arr.device.type == "cuda"
    kernel(*args)
    if cuda:
        torch.cuda.synchronize(arr.device)
    t0 = time.perf_counter()
    flat[:1].bitwise_xor_(0)
    kernel(*args)
    queue_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize(arr.device)
        torch.cuda._sleep(int(2 * (iters + 1) * queue_s * SPIN_HZ))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        flat[:1].bitwise_xor_(i & 1)
        kernel(*args)
    if cuda:
        end.record()
        end.synchronize()
        sec = start.elapsed_time(end) / 1e3
    else:
        sec = time.perf_counter() - t0
    flat[:1].copy_(first)
    return sec / iters
