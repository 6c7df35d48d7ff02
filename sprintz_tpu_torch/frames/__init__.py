"""Columnar DataFrame compression: trainable codec chains + quantization.

The port's counterpart of ``sprintz_tpu/frames``, with the same exports.
Capability parity with the reference's dataframe research line
(python/dfsqueeze.py, codec.py, dfquantize2.py, dfset.py — SURVEY §2.13):
a train/encode/decode protocol over per-column codec chains with per-frame
headers, lossless base-10 float quantization, and pluggable storage
backends (``frames.storage``, which alone needs pandas). The ``Sprintz``
column codec runs on the card.
"""

from .codecs import (  # noqa: F401
    Bz2,
    ByteShuffle,
    Codec,
    CodecSearch,
    Delta,
    DoubleDelta,
    DynamicDelta,
    Lzma,
    Quantize,
    Sprintz,
    Zigzag,
    Zlib,
)
from .dfsqueeze import decode, encode, encode_measure_decode  # noqa: F401
from .quantize import QuantizeParams, dequantize, infer_qparams, quantize  # noqa: F401
