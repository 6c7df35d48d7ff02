"""The encode side's edge shapes: inputs of K3 ``pack_rows``, of the
lowdim encode ``encode_lowdim`` and of the Huffman encoder
``encode_chunks`` where their tiles end raggedly and their widths and
codes are extreme.

One list for two users: ``tests/test_torch_encode_shapes.py`` holds the
plain versions to the JAX package at these shapes on the CPU, and
``chip_smoke.py`` holds the kernels to the plain versions at the same
shapes on the card. Inputs are numpy arrays made from the caller's
generator. Not imported by the port.
"""

from __future__ import annotations

import numpy as np

from ..entropy.huffman import HuffmanTable, build_table
from ..ops.huffman_kernels import ENC_TILE_SYMBOLS, huff_tile_chunks
from ..ops.pack_kernels import pack_tile_rows

PACK_DIMS = (5, 31, 33, 64, 129, 1024)
PACK_CASES = [(nd, es) for nd in PACK_DIMS for es in (1, 2)]
# (D, elem_sz, nb) of the lowdim encode: every lowdim width, one block, a
# span of 256 blocks and part of one (spans are 256, 512 or 1024 blocks by
# width: csrc/pack.cu's LowdimShape), one block short of 1024, and spans
# with a ragged last one
LOWDIM_PACK_CASES = [(nd, es, nb) for es, dims in ((1, (1, 2, 3, 4)),
                                                    (2, (1, 2)))
                     for nd in dims for nb in (1, 301, 1023, 4101)]
HUFF_CHUNKS = (1, 31, 128, 4096)
HUFF_KINDS = ("ragged", "short", "12-bit codes", "one symbol")
HUFF_CASES = [(cs, kind) for cs in HUFF_CHUNKS for kind in HUFF_KINDS]


def legal_widths(eb: int) -> np.ndarray:
    """Widths the encoder emits: 7 promotes to 8, and at u16 15 to 16."""
    return np.array([w for w in range(eb + 1) if w not in (7, 15)])


def lowdim_legal_widths(eb: int) -> np.ndarray:
    """Widths the lowdim encoder emits: only eb-1 promotes to eb, so 7 is
    legal at u16 (``bitmath.block_widths_lowdim``)."""
    return np.array([w for w in range(eb + 1) if w != eb - 1])


def pack_lowdim_case(rng, ndims: int, elem_sz: int, nb: int):
    """The lowdim pack's inputs: errs (nb, 8, D) int32 zigzag fields within
    their widths, widths (nb, D) int32: a block of all-zero widths, one of
    all-maximum widths, a block for each legal width in turn (at u16,
    fields across the section's two 64-bit words), then random legal
    widths."""
    eb = 8 * elem_sz
    legal = lowdim_legal_widths(eb)
    widths = legal[rng.integers(0, legal.size, (nb, ndims))]
    edge = np.concatenate([[0, eb], legal])[:nb]
    widths[:edge.size] = edge[:, None]
    errs = rng.integers(0, 1 << eb, (nb, 8, ndims)) & (
        (1 << widths) - 1)[:, None, :]
    return errs.astype(np.int32), widths.astype(np.int32)


def lowdim_rows_case(rng, ndims: int, elem_sz: int, nb: int):
    """The lowdim encode's inputs: rows (nb * 8, D) uint8/uint16 whose delta
    encode is ``pack_lowdim_case``'s errors, and those errors (nb * 8, D)
    int32 (FIRE's input form): every legal width, all-zero and all-maximum
    blocks, deltas that wrap."""
    eb = 8 * elem_sz
    errs, _ = pack_lowdim_case(rng, ndims, elem_sz, nb)
    errs = errs.reshape(-1, ndims)
    e = errs.astype(np.int64)
    rows = np.cumsum((e >> 1) ^ -(e & 1), axis=0) % (1 << eb)
    return rows.astype(np.uint8 if elem_sz == 1 else np.uint16), errs


def rows_tensor(rows: np.ndarray):
    """Narrow numpy rows as the lowdim encode takes them: uint8, or u16 as
    int16."""
    import torch

    rows = rows if rows.flags.writeable else rows.copy()
    return torch.from_numpy(rows.view(np.int16) if rows.dtype == np.uint16
                            else rows)


def pack_case(rng, ndims: int, elem_sz: int):
    """K3's inputs at D = ndims: errs (nb, 8, D) int32 zigzag fields within
    their widths, widths (nb, D) int32. Three tiles of K3: the first of
    all-zero widths, the second of all-maximum widths, and a ragged last
    one of random legal widths, so nb is no multiple of the tile."""
    eb = 8 * elem_sz
    tb = max(1, pack_tile_rows(ndims, elem_sz) // 8)  # blocks a tile
    nb = 2 * tb + max(1, (tb + 1) // 2)
    legal = legal_widths(eb)
    widths = legal[rng.integers(0, legal.size, (nb, ndims))]
    widths[:tb] = 0
    widths[tb:2 * tb] = eb
    errs = rng.integers(0, 1 << eb, (nb, 8, ndims)) & (
        (1 << widths) - 1)[:, None, :]
    return errs.astype(np.int32), widths.astype(np.int32)


def twelve_bit_table() -> HuffmanTable:
    """A table in which some symbols have 12-bit codes: that of a
    Fibonacci-like histogram over 30 symbols."""
    fib = np.repeat(np.arange(30), [int(1.6 ** k) + 1 for k in range(30)])
    return build_table(fib.astype(np.uint8))


def huff_case(rng, cs: int, kind: str):
    """The encoder's inputs at chunk size cs -> (symbols (n,) uint8, the
    table to code them with, or None for their own):

    - "ragged": two tiles and a part, the last chunk part full;
    - "short": fewer symbols than a chunk (one at cs 1);
    - "12-bit codes": only the symbols whose codes have 12 bits;
    - "one symbol": one symbol value throughout.
    """
    tile = cs * huff_tile_chunks(cs)
    n = 2 * tile + max(1, min(cs, ENC_TILE_SYMBOLS) // 2) + 7
    if kind == "ragged":
        skew = np.minimum(rng.geometric(0.35, n) - 1, 255)
        return skew.astype(np.uint8), None
    if kind == "short":
        return rng.integers(0, 40, max(1, cs // 2)).astype(np.uint8), None
    if kind == "12-bit codes":
        t = twelve_bit_table()
        long_ = np.flatnonzero(t.lengths == 12).astype(np.uint8)
        return long_[rng.integers(0, long_.size, n)], t
    if kind == "one symbol":
        return np.full(n, 42, np.uint8), None
    raise ValueError(f"unknown kind {kind!r}")
