"""Bit-math primitives on int32 tensors: zigzag, bit widths, header fields.

Counterpart of ``sprintz_tpu/ops/bitmath.py``. Every function takes and
returns int32 tensors (torch's uint16 has no shifts on the CPU, so narrow
unsigned types are for storage and transfer only).
"""

from __future__ import annotations

import torch


def zigzag_encode(x: torch.Tensor, elem_bits: int) -> torch.Tensor:
    """Signed err -> unsigned zigzag, in int32.

    Input values must be sign-extended int32 in [-2^(eb-1), 2^(eb-1)).
    Returns int32 in [0, 2^eb).
    """
    return ((x << 1) ^ (x >> 31)) & ((1 << elem_bits) - 1)


def zigzag_decode(u: torch.Tensor, elem_bits: int) -> torch.Tensor:
    """Unsigned zigzag (int32) -> sign-extended int32."""
    val = (u >> 1) ^ -(u & 1)
    return sign_extend(val, elem_bits)


def sign_extend(x: torch.Tensor, elem_bits: int) -> torch.Tensor:
    """Reinterpret the low elem_bits of int32 values as signed."""
    shift = 32 - elem_bits
    return (x << shift) >> shift


def bit_length(x: torch.Tensor, max_bits: int) -> torch.Tensor:
    """Bit length (position of highest set bit + 1) of non-negative int32
    values. Exact for x < 2^max_bits."""
    width = torch.zeros_like(x, dtype=torch.int32)
    for k in range(max_bits):
        width += (x >= (1 << k)).to(torch.int32)
    return width


def block_widths_rowmajor(blockmax: torch.Tensor, elem_sz: int) -> torch.Tensor:
    """Row-major per-dim width from the MAX of a block's zigzag values.

    The reference takes the OR of the block's values. torch has no
    bitwise-OR reduction, but for non-negative values the OR and the max
    have the same highest set bit, so ``bit_length(OR) == bit_length(max)``,
    and the same holds for the u16 high byte (``OR >> 8`` and ``max >> 8``).
    When the high byte is zero every value is below 256, so the low-byte
    rule sees the same bit length too. Widths and zero flags are therefore
    those of the OR.

    8b: legal widths {0..6, 8}: 7 promotes to 8 (bitpack.h:72).
    16b: if any high bit is set, the low byte is kept in full:
    width = 8 + promote7(bitlen(hi)); else promote7(bitlen(lo))
    (sprintz_delta_rle.cpp:177-187).
    """
    if elem_sz == 1:
        w = bit_length(blockmax, 8)
        return w + (w == 7).to(torch.int32)
    hi = blockmax >> 8
    lo = blockmax & 0xFF
    whi = bit_length(hi, 8)
    whi = whi + (whi == 7).to(torch.int32)
    wlo = bit_length(lo, 8)
    wlo = wlo + (wlo == 7).to(torch.int32)
    return torch.where(hi > 0, 8 + whi, wlo)


def block_widths_lowdim(blockmax: torch.Tensor, elem_sz: int) -> torch.Tensor:
    """Lowdim per-dim width from the MAX of a block's zigzag values: the
    bit length, with only eb-1 promoted to eb (sprintz_delta_lowdim.cpp:
    176-177). As in ``block_widths_rowmajor``, the max has the OR's bit
    length. u8 legal widths {0..6, 8}, u16 {0..14, 16}: 7 stays 7 at u16.
    """
    eb = 8 * elem_sz
    w = bit_length(blockmax, eb)
    return w + (w == eb - 1).to(torch.int32)


def header_value(widths: torch.Tensor, elem_bits: int) -> torch.Tensor:
    """Stored header field: width, with elem_bits mapped to elem_bits-1
    (sprintz_delta_rle.cpp:199)."""
    return widths - (widths == elem_bits).to(widths.dtype)


def header_to_width(h, elem_bits: int):
    """Decoder mapping: elem_bits-1 -> elem_bits (sprintz_delta.cpp:563-566).

    Takes an integer tensor or numpy array (the host header walk) and keeps
    its dtype: both libraries add a bool to an integer in the integer's
    type.
    """
    return h + (h == elem_bits - 1)
