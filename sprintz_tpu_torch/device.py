"""Device selection for the port's entry points, and the float32 matmul
precision of its search and learning."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when CUDA is asked for (explicitly or by default) and absent:
    the port never moves to the CPU quietly. ``"cpu"`` runs the kernels'
    plain PyTorch versions and is meant for tests.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sprintz_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions (tests)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def exact_fp32_matmul():
    """float32 matrix products at full precision inside the block, whatever
    the caller set: the JAX package's ``Precision.HIGHEST``, exact on
    integer data up to 2^24. TF32 (``allow_tf32``,
    ``set_float32_matmul_precision``, the backends' ``fp32_precision``)
    and oneDNN's bf16 on the CPU are off inside; the caller's settings come
    back afterwards. Legacy and per-backend settings are kept consistent
    inside, as the matmul's checks require; a caller whose settings were
    already inconsistent (legacy and new APIs mixed, so that
    ``get_float32_matmul_precision`` raises) gets its per-backend settings
    back, and the legacy one at "highest"."""
    backends = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    prev = [b.fp32_precision for b in backends]
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:  # the legacy and new APIs were mixed
        legacy = None
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        for b, p in zip(backends, prev):
            b.fp32_precision = p
