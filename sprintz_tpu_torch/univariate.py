"""Univariate codec façade.

Counterpart of ``sprintz_tpu/univariate.py``: the capability of the
reference's univariate codecs (univariate_8b.cpp) through the framework's
production codecs, each method's bytes those of the JAX package:

- "sprintz"    : the lowdim ndims=1 Sprintz path (delta or FIRE + RLE),
                 ``SprintzCodec(codec, elem_sz, device=...)``, on the card
- "delta"/"doubledelta"/"tripledelta": whole-buffer nth-order transforms
- "dyndelta"   : per-block delta vs double-delta choice (u16)
- the nine reference legacy byte formats (``univariate8b``):
                 "delta_simple8b", "delta8b", "online8b", "delta_online8b",
                 "delta2_online8b", "delta_rle8b", "delta_rle28b",
                 "doubledelta8b", "dyndelta8b"
- "sprintzpack": per-block bitpack without prediction (u16)

Only "sprintz" has a device pass (``device``: CUDA by default, ``"cpu"``
for tests); the others are host codecs (``models.online``,
``univariate8b``), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from . import univariate8b as u8b
from .api import SprintzCodec
from .models import online

_ENCODERS_8B = {
    "delta8b": u8b.compress_delta_8b,
    "delta_simple8b": u8b.compress_delta_simple_8b,
    "online8b": u8b.compress_online_8b,
    "delta_online8b": u8b.compress_delta_online_8b,
    "delta2_online8b": u8b.compress_delta2_online_8b,
    "delta_rle8b": u8b.compress_delta_rle_8b,
    "delta_rle28b": u8b.compress_delta_rle2_8b,
    "doubledelta8b": u8b.compress_doubledelta_8b,
    "dyndelta8b": u8b.compress_dyndelta_8b,
}
_DECODERS_8B = {
    "delta8b": u8b.decompress_delta_8b,
    "delta_simple8b": u8b.decompress_delta_simple_8b,
    "online8b": u8b.decompress_online_8b,
    "delta_online8b": u8b.decompress_delta_online_8b,
    "delta2_online8b": u8b.decompress_delta2_online_8b,
    "delta_rle8b": u8b.decompress_delta_rle_8b,
    "delta_rle28b": u8b.decompress_delta_rle2_8b,
    "doubledelta8b": u8b.decompress_doubledelta_8b,
    "dyndelta8b": u8b.decompress_dyndelta_8b,
}
_ORDERS = {"delta": 1, "doubledelta": 2, "tripledelta": 3}


def compress_univariate(x: np.ndarray, method: str = "sprintz",
                        codec: str = "delta",
                        device: str | torch.device | None = None) -> bytes:
    x = np.ascontiguousarray(x)
    if method == "sprintz":
        return SprintzCodec(codec, x.dtype.itemsize, device=device).compress(x)
    if method == "dyndelta":
        return online.dynamic_delta_pack_u16(x.astype(np.uint16))
    if method.endswith("8b"):
        return _ENCODERS_8B[method](x.astype(np.uint8))
    if method == "sprintzpack":
        return online.sprintzpack_pack_u16(x.astype(np.uint16), zigzag=True)
    if method in _ORDERS:
        order = _ORDERS[method]
        errs = online.nth_order_delta_encode(x.astype(np.uint16), order)
        return (bytes([order]) + int(x.size).to_bytes(4, "little")
                + errs.tobytes())
    raise ValueError(f"unknown univariate method {method!r}")


def decompress_univariate(buf: bytes, method: str = "sprintz",
                          codec: str = "delta", elem_sz: int = 1,
                          device: str | torch.device | None = None
                          ) -> np.ndarray:
    if method == "sprintz":
        return SprintzCodec(codec, elem_sz, device=device).decompress(buf)
    if method == "dyndelta":
        return online.dynamic_delta_unpack_u16(buf)
    if method.endswith("8b"):
        return _DECODERS_8B[method](buf)
    if method == "sprintzpack":
        return online.sprintzpack_unpack_u16(buf, zigzag=True)
    if method in _ORDERS:
        order = buf[0]
        n = int.from_bytes(buf[1:5], "little")
        errs = np.frombuffer(buf, dtype=np.int16, count=n, offset=5)
        return online.nth_order_delta_decode(errs, order)
    raise ValueError(f"unknown univariate method {method!r}")
