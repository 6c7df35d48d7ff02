"""The benchmark's frozen reference: a plain Sprintz codec in NumPy.

It imports nothing of the program under test (``sprintz_tpu_torch``),
of the JAX package or of JAX."""

from .sprintz import decode, encode, format_trunc_bits, is_lowdim

__all__ = ["decode", "encode", "format_trunc_bits", "is_lowdim"]
