"""Format constants of the Sprintz stream, for the PyTorch port.

The stream format is byte-compatible with the reference sprintz
implementation. Constant provenance (reference sources):

- ``BLOCK_SZ``/``GROUP_SZ_BLOCKS``: sprintz_delta.cpp:73,48
- header field width 3/4 bits: sprintz_delta.cpp:71
- ``MAX_RUN_NBLOCKS`` (15-bit run counter): sprintz_delta_rle.cpp:68
- min compressible size (below which streams are stored verbatim):
  sprintz_delta_rle.cpp:71,101-109
- metadata layout: format.h:31-33
"""

from __future__ import annotations

# Samples (rows) per block. 8 rows x w bits always lands on a byte boundary.
BLOCK_SZ = 8
LOG2_BLOCK_SZ = 3

# Blocks per group: one group header region covers this many blocks.
GROUP_SZ_BLOCKS = 2

# Zero-run length cap: lengths are coded as a 7/15-bit varint.
MAX_RUN_NBLOCKS = 0x7FFF

# Streams shorter than this many elements are stored verbatim (ngroups == 0).
MIN_DATA_SIZE = 8 * BLOCK_SZ * GROUP_SZ_BLOCKS  # == 128 elements

# {u32 ngroups, u16 remaining_len, u16 ndims}, little-endian (format.h:35-45).
METADATA_LEN_RLE = 8

# The non-RLE streams' headers: {u32 len, u16 ndims} (format.h:64-72), and
# the legacy xff codec's {u48 len, u16 ndims} (sprintz_xff.cpp:64-69).
METADATA_LEN_SIMPLE = 6
METADATA_LEN_XFF = 8

# Max dims handled by the column-major low-dimensional layout
# (sprintz_delta_lowdim.cpp:64-70): sample row must fit in 32 bits.
LOWDIM_MAX_NDIMS = {1: 4, 2: 2}  # elem_sz -> max ndims

# FIRE (xff) hyperparameters (sprintz_xff_rle.cpp:74-76): the coefficient
# is the learning counter >> FIRE_LEARNING_SHIFT, and the gradient is taken
# on every 2^FIRE_LOG2_LEARNING_DOWNSAMPLE-th row (the odd rows).
FIRE_LEARNING_SHIFT = 1
FIRE_LOG2_LEARNING_DOWNSAMPLE = 1

# The standalone preprocessor's FIRE (transforms.py's xff head) takes its
# own learning shift (predict.cpp:62): 1 for u8 streams, 3 for u16.
TRANSFORM_LEARNING_SHIFT = {1: 1, 2: 3}  # elem_sz -> shift

# Width of FIRE's learning counter: int16 for u8 streams, int32 for u16
# (sprintz_xff_rle.cpp's counter_t).
FIRE_COUNTER_BITS = {1: 16, 2: 32}  # elem_sz -> counter bits


def nbits_sz_bits(elem_sz: int) -> int:
    """Width of one per-dim bitwidth header field: 3 bits (u8), 4 bits (u16)."""
    return 3 if elem_sz == 1 else 4
