"""The delta decode's edge cases: inputs of the unpack kernel (K1
``unpack_zz``, K4 ``unpack_rows``, K5 its narrow mode), of the lowdim
decode (``decode_delta_lowdim``, raw mode ``unpack_dims_lowdim``) and of
K2 ``prefix_finish`` where their tiles end raggedly, their rows are odd
or wide, and their payloads are short, empty or misaligned.

One list for two users: ``tests/test_torch_unpack_shapes.py`` holds the
plain versions to the JAX package at these cases on the CPU, and
``chip_smoke.py`` holds the kernels to the plain versions at the same
cases on the card. Not imported by the port.

A case is (elem_bits, D, nb, kind):

- "random": random legal widths, with a block of all-zero widths, one of
  all-maximum widths, one of every legal width in turn and, at u16, two
  that put 16-bit fields at bit offsets 1, 3 and 7 (fields of 23 bits
  after the shift);
- "zero widths": every third block and a whole tile of blocks with all
  widths 0 (the run blocks of a stream with runs);
- "narrow maxb": MAXB cut to three quarters of the widest row (below the
  row width too), so that in most rows a field runs past it, by one to
  three bytes, and reads zeros there;
- "misaligned": the payload starts one byte past a 16-byte boundary;
- "wide": rows wider than the shared memory of one tile, which the
  kernels take in chunks of dims (at u16 D 400, an odd number of them,
  over three tiles).

``LOWDIM_CASES`` are the lowdim layout's (u8 D 1-4, u16 D 1-2):
"random" (legal lowdim widths, with a block of all-zero widths, one of
all-maximum widths, and one block for each legal width in turn, which at
u16 widths 9-14 puts a field across the section's two 64-bit words),
"zero widths" and "misaligned" as above. The lowdim decode's spans are
256, 512 or 1024 blocks by width (1024 at u8 D 1, 512 at u8 D 2 and u16
D 1): nb 1, 31, 33 and 100 lie in one span, 257 and 1025 start a span
with one block, 1023 ends one block short of a second span, and 4101
ends several spans raggedly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.decode_kernels import TILE_BLOCKS
from ..ops.pack_kernels import pack_dims_lowdim_plain, pack_rows_plain
from .encode_cases import legal_widths, lowdim_legal_widths

UNPACK_CASES = [
    (8, 5, 33, "random"),
    (8, 13, 31, "random"),
    (8, 64, 4101, "random"),
    (8, 129, 1, "random"),
    (8, 64, 100, "zero widths"),
    (8, 64, 31, "narrow maxb"),
    (8, 13, 33, "misaligned"),
    (8, 600, 33, "wide"),
    (16, 3, 33, "random"),
    (16, 40, 4101, "random"),
    (16, 129, 31, "random"),
    (16, 13, 1, "misaligned"),
    (16, 64, 100, "zero widths"),
    (16, 40, 33, "narrow maxb"),
    (16, 400, 70, "wide"),
]

LOWDIM_CASES = [
    (8, 1, 4101, "random"),
    (8, 1, 31, "zero widths"),
    (8, 2, 33, "random"),
    (8, 2, 100, "misaligned"),
    (8, 2, 1025, "random"),
    (8, 3, 257, "random"),
    (8, 3, 100, "zero widths"),
    (8, 4, 1, "random"),
    (8, 4, 31, "random"),
    (8, 4, 4101, "zero widths"),
    (16, 1, 33, "random"),
    (16, 1, 31, "misaligned"),
    (16, 1, 1023, "zero widths"),
    (16, 2, 4101, "random"),
    (16, 2, 1, "random"),
    (16, 2, 100, "zero widths"),
]


def case_widths(rng, eb: int, ndims: int, nb: int, kind: str) -> np.ndarray:
    """(nb, D) uint8 widths of a case."""
    legal = legal_widths(eb)
    w = legal[rng.integers(0, legal.size, (nb, ndims))]
    if kind == "zero widths":
        w[::3] = 0
        w[TILE_BLOCKS:2 * TILE_BLOCKS] = 0
    elif kind != "narrow maxb":
        edge = [np.zeros(ndims), np.full(ndims, eb),
                legal[np.arange(ndims) % legal.size]]
        if eb == 16:
            edge += [np.where(np.arange(ndims) % 2 == 0, 3, 16),  # off & 7: 3, 7
                     np.where(np.arange(ndims) == 0, 1, 16)]  # off & 7: 1
        for b, row in enumerate(edge[:nb]):
            w[b] = row
    return w.astype(np.uint8)


def lowdim_case_widths(rng, eb: int, ndims: int, nb: int,
                       kind: str) -> np.ndarray:
    """(nb, D) uint8 lowdim widths of a case."""
    legal = lowdim_legal_widths(eb)
    w = legal[rng.integers(0, legal.size, (nb, ndims))]
    if kind == "zero widths":
        w[::3] = 0
        w[TILE_BLOCKS:2 * TILE_BLOCKS] = 0
    else:
        edge = np.concatenate([[0, eb], legal])[:nb]
        w[:edge.size] = edge[:, None]
    return w.astype(np.uint8)


def lowdim_case(rng, eb: int, ndims: int, nb: int, kind: str):
    """-> (dense (nb, D, EB) uint8, widths (nb, D) uint8, fields
    (nb, 8, D) int64): random zigzag fields within their widths, packed in
    sections as a lowdim stream packs them."""
    w = lowdim_case_widths(rng, eb, ndims, nb, kind)
    fields = rng.integers(0, 1 << eb, (nb, 8, ndims)) & (
        (1 << w.astype(np.int64)) - 1)[:, None, :]
    dense = pack_dims_lowdim_plain(torch.from_numpy(fields.astype(np.int32)),
                                   torch.from_numpy(w.astype(np.int32)),
                                   eb // 8).numpy()
    return dense, w, fields


def unpack_case(rng, eb: int, ndims: int, nb: int, kind: str):
    """-> (dense (nb, 8, MAXB) uint8, widths (nb, D) uint8, fields
    (nb, 8, D) int64): random zigzag fields within their widths, packed
    as a stream packs them; for "narrow maxb" the dense rows are cut
    below their widest row, and the fields are what remains of them."""
    w = case_widths(rng, eb, ndims, nb, kind)
    fields = rng.integers(0, 1 << eb, (nb, 8, ndims)) & (
        (1 << w.astype(np.int64)) - 1)[:, None, :]
    dense = pack_rows_plain(torch.from_numpy(fields.astype(np.int32)),
                            torch.from_numpy(w.astype(np.int32)),
                            eb // 8).numpy()
    if kind == "narrow maxb":
        widest = int((w.astype(np.int64).sum(axis=1).max() + 7) // 8)
        maxb = max(1, widest * 3 // 4)
        assert maxb < ndims * eb // 8
        dense = np.ascontiguousarray(dense[:, :, :maxb])
        fields = cut_fields(fields, w, maxb)
    return dense, w, fields


def cut_fields(fields: np.ndarray, widths: np.ndarray, maxb: int) -> np.ndarray:
    """The fields as a row cut at byte maxb holds them: bits at or past
    8 * maxb read as zero."""
    w = widths.astype(np.int64)
    off = np.cumsum(w, axis=1) - w
    keep = np.clip(8 * maxb - off, 0, 62)
    return fields & ((1 << keep) - 1)[:, None, :]


def to_device(dense: np.ndarray, widths: np.ndarray, kind: str, device):
    """The case's (dense, widths) as tensors on ``device``; a "misaligned"
    case's dense is a view that starts one byte past a 16-byte boundary."""
    w = torch.from_numpy(widths).to(device)
    if kind != "misaligned":
        return torch.from_numpy(dense).to(device), w
    flat = torch.empty(dense.size + 16, dtype=torch.uint8, device=device)
    skip = (1 - flat.data_ptr()) % 16
    d = flat[skip:skip + dense.size].view(dense.shape)
    d.copy_(torch.from_numpy(dense))
    assert d.data_ptr() % 16 == 1 and d.is_contiguous()
    return d, w

# the delta chunk seed: (elem_bits, ndims, blocks, chunks), chunks of
# unequal lengths (empty ones too) at chunk counts 1, 2, 7 and 33
SEED_CASES = [(8, 64, 40, 7), (16, 3, 33, 33), (8, 1, 5, 1), (16, 130, 12, 2),
              (8, 4, 300, 33)]

# the chunked delta decode where its chunk starts fall on the tiles (K1 and
# K2: 32 blocks) and spans (the lowdim decode: 256, 512 or 1024 blocks) in
# every way: (what, elem_bits, ndims, blocks, chunk starts as C + 1 blocks)
CHUNK_CASES = [
    ("starts mid-tile", 8, 5, 100, [0, 13, 45, 77, 100]),
    ("several starts in a tile", 16, 3, 90, [0, 3, 5, 6, 20, 31, 40, 41, 90]),
    ("starts at a tile's last block", 8, 64, 97, [0, 31, 63, 95, 97]),
    ("empty chunks", 16, 2, 70, [0, 0, 10, 10, 10, 32, 70, 70]),
    ("one chunk over many tiles and spans", 8, 4, 3000, [0, 5, 2990, 3000]),
    ("long and short chunks", 8, 1, 2500,
     [0, 1, 2, 3, 1100, 1101, 1130, 2047, 2048, 2049, 2500]),
    ("starts at span edges", 16, 1, 1300, [0, 511, 512, 513, 1024, 1300]),
    ("rows wider than a tile's shared memory", 8, 600, 40, [0, 17, 33, 40]),
]
