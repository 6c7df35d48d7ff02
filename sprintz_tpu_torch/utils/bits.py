"""Bit-twiddling helpers on the host (numpy).

The port's copy of ``sprintz_tpu/utils/bits.py``: zigzag, ``icopysign``,
row bit packing and run varints, for host code and tests; the device
pass's counterparts are the torch operations of ``ops/bitmath.py``.

All helpers use explicit numpy dtypes so that wraparound, arithmetic shifts
and narrowing truncations match the C integer semantics of the reference
(zigzag macros: bitpack.h:302-317; icopysign: util.h:63-74).
"""

from __future__ import annotations

import numpy as np


def zigzag_encode(x: np.ndarray) -> np.ndarray:
    """Signed -> unsigned zigzag: 0,-1,1,-2,2,... -> 0,1,2,3,4,...

    Matches ``ZIGZAG_ENCODE_SCALAR`` (bitpack.h:302) for int8/int16 inputs.
    """
    if x.dtype == np.int8:
        wide, nbits, out = np.int16, 8, np.uint8
    elif x.dtype == np.int16:
        wide, nbits, out = np.int32, 16, np.uint16
    else:
        raise TypeError(f"zigzag_encode: unsupported dtype {x.dtype}")
    w = x.astype(wide)
    return ((w << 1) ^ (w >> (nbits - 1))).astype(out)


def zigzag_decode(u: np.ndarray) -> np.ndarray:
    """Unsigned zigzag -> signed. Matches ``ZIGZAG_DECODE_SCALAR`` (bitpack.h:303)."""
    if u.dtype == np.uint8:
        out = np.int8
    elif u.dtype == np.uint16:
        out = np.int16
    else:
        raise TypeError(f"zigzag_decode: unsupported dtype {u.dtype}")
    half = (u >> 1).astype(out)
    neg = -((u & 1).astype(out))
    return half ^ neg


def icopysign(sign_of: np.ndarray, val: np.ndarray) -> np.ndarray:
    """val with the sign of ``sign_of``; 0 where ``sign_of`` is 0 (util.h:63-74).

    Operates in the (signed) dtype of the inputs with wraparound.
    """
    nbits = 8 * sign_of.dtype.itemsize
    mask = sign_of >> (nbits - 1)  # arithmetic shift: 0 or -1
    maybe_negated = (val ^ mask) - mask
    return np.where(sign_of != 0, maybe_negated, 0).astype(val.dtype)


def pack_row_bits(values: np.ndarray, widths: np.ndarray) -> int:
    """Concatenate per-dim values LSB-first in dim order into one big int.

    values[d] contributes its low widths[d] bits at bit offset
    sum(widths[:d]). This is the arbitrary-width equivalent of the
    reference's per-stripe ``_pext_u64`` packing (sprintz_delta_rle.cpp:345-381).
    """
    acc = 0
    off = 0
    for v, w in zip(values.tolist(), widths.tolist()):
        if w:
            acc |= (int(v) & ((1 << w) - 1)) << off
            off += w
    return acc


def unpack_row_bits(row_int: int, widths: np.ndarray, out_dtype) -> np.ndarray:
    """Inverse of pack_row_bits: extract per-dim fields from one big int."""
    out = np.zeros(len(widths), dtype=out_dtype)
    off = 0
    for d, w in enumerate(widths.tolist()):
        if w:
            out[d] = (row_int >> off) & ((1 << w) - 1)
            off += w
    return out


def encode_run_varint(run_length: int) -> bytes:
    """7/15-bit run-length varint (sprintz_delta_rle.cpp:268-276).

    Low 7 bits in byte 0; if the run exceeds 0x7f, byte 0's MSB is set and
    the high 8 bits follow in byte 1.
    """
    if run_length <= 0x7F:
        return bytes([run_length & 0x7F])
    return bytes([0x80 | (run_length & 0x7F), (run_length >> 7) & 0xFF])


def decode_run_varint(buf: bytes, pos: int) -> tuple[int, int]:
    """Read a run-length varint at ``pos``; returns (length, new_pos)."""
    low = buf[pos]
    pos += 1
    length = low & 0x7F
    if low & 0x80:
        length |= buf[pos] << 7
        pos += 1
    return length, pos
