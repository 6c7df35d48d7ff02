"""Delta forecaster on int32 tensors.

Counterpart of the delta half of ``sprintz_tpu/models/forecasters.py``.
Delta is an exact prefix sum: encode is a shifted subtract, decode one
cumulative sum over rows. The decode path itself runs through the kernels
of ``ops/decode_kernels.py``; ``delta_decode`` here is the plain reference.
"""

from __future__ import annotations

import torch

from ..ops.bitmath import sign_extend, zigzag_decode, zigzag_encode


def delta_encode(rows: torch.Tensor, elem_bits: int) -> torch.Tensor:
    """rows: (N, D) int32 holding unsigned values -> zigzag errs (N, D) int32."""
    prev = torch.cat([torch.zeros_like(rows[:1]), rows[:-1]], dim=0)
    deltas = sign_extend(rows - prev, elem_bits)
    return zigzag_encode(deltas, elem_bits)


def delta_decode(errs_zz: torch.Tensor, elem_bits: int) -> torch.Tensor:
    """Inverse of delta_encode: (N, D) zigzag errs -> values (N, D) int32.

    An integer cumsum in int32; it may wrap, which the eb-bit mask absorbs.
    """
    deltas = zigzag_decode(errs_zz, elem_bits)
    return (torch.cumsum(deltas, dim=0, dtype=torch.int32)
            & ((1 << elem_bits) - 1))
