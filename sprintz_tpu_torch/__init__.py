"""sprintz_tpu_torch: the Sprintz codec on PyTorch and CUDA (NVIDIA H100).

A port of ``sprintz_tpu`` that imports neither JAX nor the JAX package.
It covers the delta and FIRE (xff) codecs in both layouts (u8 and u16,
RLE of zero blocks), the +Huf entropy stage and checkpoint sidecars
(``SprintzCodec.compress_seekable``, ``decompress(sidecar=)``,
``checkpoint.decode_range``); the kernels are CUDA C++ under ``csrc/``,
built with nvcc at first use. Streams are byte-identical to the reference
codec and to the JAX package.
"""

from .api import Sidecar, SprintzCodec, compress, decompress
from .errors import CorruptStreamError

__all__ = ["CorruptStreamError", "Sidecar", "SprintzCodec", "compress",
           "decompress"]
