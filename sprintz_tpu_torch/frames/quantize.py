"""Lossless float -> integer quantization for columnar data.

The port's copy of ``sprintz_tpu/frames/quantize.py`` (numpy, host): its
parameters and codes are the JAX package's. Mirrors the capability of the
reference's dfquantize2.py:17-185: infer a decimal scale such that
``round((x - offset) * scale)`` reconstructs the column bit-exactly (data
recorded with a fixed number of base-10 decimal places), with NaN handled
by reserving the top code.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class QuantizeParams:
    dtype: str  # target unsigned dtype name
    offset: float  # integer offset in the scaled domain: round(min(x)*scale)
    scale: float  # x ~ (q + offset) / scale
    orig_dtype: str
    allfinite: bool


def _fits(x: np.ndarray, ioffset: float, scale: float) -> bool:
    # quantize in the absolute scaled-integer domain so dequantization
    # reproduces the original float64 bit pattern (0.001 etc. are not
    # binary-exact; round(x*scale) is)
    q = np.round(x * scale) - ioffset
    return bool(np.all(((q + ioffset) / scale).astype(x.dtype) == x))


def infer_qparams(x: np.ndarray, mode: str = "lossless_base10",
                  max_decimal_digits: int = 6) -> QuantizeParams | None:
    """Infer quantization parameters; None if the column can't be losslessly
    quantized within u64 range."""
    x = np.asarray(x)
    orig = x.dtype.name
    finite = np.isfinite(x)
    allfinite = bool(finite.all())
    xf = x[finite]
    if xf.size == 0:
        return QuantizeParams("uint8", float("nan"), float("nan"), orig, False)

    if mode == "rescale_u8":
        lo, hi = float(xf.min()), float(xf.max()) - float(xf.min())
        scale = min(1.0, 254.0 / hi) if hi > 0 else 1.0
        return QuantizeParams("uint8", lo * scale, scale, orig, allfinite)
    if mode == "rescale_u16":
        lo, hi = float(xf.min()), float(xf.max()) - float(xf.min())
        scale = min(1.0, 65534.0 / hi) if hi > 0 else 1.0
        return QuantizeParams("uint16", lo * scale, scale, orig, allfinite)

    assert mode == "lossless_base10"
    for digits in range(max_decimal_digits + 1):
        scale = float(10 ** digits)
        ioffset = float(np.round(float(xf.min()) * scale))
        if _fits(xf, ioffset, scale):
            span = float(np.round(float(xf.max()) * scale)) - ioffset
            # reserve one code for NaN when needed
            span += 0 if allfinite else 1
            for dt, lim in [("uint8", 255), ("uint16", 65535),
                            ("uint32", (1 << 32) - 1),
                            ("uint64", (1 << 53))]:  # float-exact range
                if span <= lim:
                    return QuantizeParams(dt, ioffset, scale, orig, allfinite)
    return None


def quantize(x: np.ndarray, p: QuantizeParams) -> np.ndarray:
    x = np.asarray(x)
    dt = np.dtype(p.dtype)
    if not np.isfinite(p.offset):  # all-NaN column
        return np.zeros(x.shape, dtype=dt)
    q = np.round(np.nan_to_num(x, nan=p.offset / p.scale) * p.scale) - p.offset
    out = q.astype(dt)
    if not p.allfinite:
        nan_code = np.iinfo(dt).max
        out = np.where(np.isfinite(x), np.minimum(out, nan_code - 1),
                       nan_code).astype(dt)
    return out


def dequantize(q: np.ndarray, p: QuantizeParams) -> np.ndarray:
    odt = np.dtype(p.orig_dtype)
    if not np.isfinite(p.offset):
        return np.full(q.shape, np.nan, dtype=odt)
    vals = ((q.astype(np.float64) + p.offset) / p.scale).astype(odt)
    if not p.allfinite:
        nan_code = np.iinfo(np.dtype(p.dtype)).max
        vals = np.where(q == nan_code, np.array(np.nan, dtype=odt), vals)
    return vals
