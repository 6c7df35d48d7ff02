"""sprintz_tpu_torch: the Sprintz codec on PyTorch and CUDA (NVIDIA H100).

A port of ``sprintz_tpu`` that imports neither JAX nor the JAX package.
It covers the delta codec in the row-major layout (u8 and u16, RLE of zero
blocks); the kernels are CUDA C++ under ``csrc/``, built with nvcc at first
use. Streams are byte-identical to the reference codec.
"""

from .api import SprintzCodec, compress, decompress
from .errors import CorruptStreamError

__all__ = ["CorruptStreamError", "SprintzCodec", "compress", "decompress"]
