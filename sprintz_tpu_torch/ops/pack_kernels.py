"""Row-major bit-pack and raw unpack kernels.

Counterpart of ``sprintz_tpu/ops/pallas_pack.py``:

- K3 ``pack_rows`` (``csrc/pack.cu``): zigzag errors + widths -> the dense
  per-block payload rows.
- K4 ``unpack_rows`` (``csrc/decode.cu``, the raw mode of K1's kernel):
  dense payload rows + widths -> the raw zigzag fields, int32. Its
  ``narrow=True`` mode is K5, the counterpart of ``unpack_rows_pallas_mxu``
  with its bf16 output (exact for u8 fields): for u8 streams, it writes the
  fields as uint8, a quarter of K4's output bytes.

As in ``decode_kernels``, each wrapper launches its kernel for a CUDA
tensor and runs its plain PyTorch version for a CPU tensor, and counts its
launches in its ``launches`` attribute (``unpack_rows`` counts its narrow
mode, K5, apart, in ``narrow_launches``).
"""

from __future__ import annotations

import torch

from ..constants import BLOCK_SZ
from . import _build
from .decode_kernels import TILE_BLOCKS, check_args, check_payload, extract_fields

# ------------------------------------------------------------------ K3

# A CTA of K3 packs a tile of rows (csrc/pack.cu): about PACK_TILE_ELEMS
# errors (two rounds of four 16-byte loads for each of its 128 threads; on
# the H100 this beat 256 threads a round and tiles of 1024 or 2048
# errors, sprintz_tpu_torch/probes/encode_ab.py), in whole blocks
# of 16 rows or more; where those do not fit the default 48 KB of shared
# memory, part of a block (8, 4, 2 or 1 rows); a row alone up to the 227 KB
# a CTA may opt in to.
PACK_TILE_ELEMS = 4096
SMEM_DEFAULT = 48 * 1024
SMEM_MAX = 227 * 1024


def pack_smem_bytes(tile_rows: int, ndims: int, elem_sz: int) -> int:
    """Shared memory of a K3 tile, as ``csrc/pack.cu`` sizes it: the
    staging image of the tile's output bytes (from the 16-byte boundary
    below them) and a word of offset and width for each dim of each of
    its blocks."""
    stage = (tile_rows * ndims * elem_sz + 30) // 16 * 16
    return stage + 4 * ndims * max(1, tile_rows // BLOCK_SZ)


def pack_tile_rows(ndims: int, elem_sz: int) -> int:
    """The rows of a K3 tile at this width (see PACK_TILE_ELEMS)."""
    whole = max(2 * BLOCK_SZ, PACK_TILE_ELEMS // ndims // 16 * 16)
    for rows in (whole, 8, 4, 2, 1):
        if pack_smem_bytes(rows, ndims, elem_sz) <= SMEM_DEFAULT:
            return rows
    if pack_smem_bytes(1, ndims, elem_sz) <= SMEM_MAX:
        return 1
    raise ValueError(f"pack_rows: a row of {ndims} dims at elem_sz {elem_sz} "
                     f"outgrows the card's shared memory")


def pack_rows_plain(errs_zz: torch.Tensor, widths: torch.Tensor,
                    elem_sz: int) -> torch.Tensor:
    """Plain version of ``pack_rows``: each field, masked to its width and
    shifted by ``off & 7`` (<= 23 bits), adds its 3 bytes at byte
    ``off >> 3`` of the row. Fields are bit-disjoint, so the sum is an OR."""
    nb, _, ndims = errs_zz.shape
    maxb = ndims * elem_sz
    off = torch.cumsum(widths, dim=1, dtype=torch.int32) - widths
    mask = ((1 << widths) - 1).unsqueeze(1)
    c = (errs_zz & mask) << (off & 7).unsqueeze(1)
    q = (off >> 3).long().unsqueeze(1).expand(-1, BLOCK_SZ, -1)
    out = torch.zeros((nb, BLOCK_SZ, maxb + 2), dtype=torch.int32,
                      device=errs_zz.device)
    for k in range(3):
        out.scatter_add_(2, q + k, (c >> (8 * k)) & 0xFF)
    return out[:, :, :maxb].to(torch.uint8)


def pack_rows(errs_zz: torch.Tensor, widths: torch.Tensor,
              elem_sz: int) -> torch.Tensor:
    """errs_zz (nb, 8, D) int32 zigzag errors, widths (nb, D) int32 legal
    widths -> dense (nb, 8, MAXB = D * elem_sz) uint8. Row r of block b
    holds its fields in its first ceil(sum(widths[b]) / 8) bytes, zeros
    after."""
    if elem_sz not in (1, 2):
        raise ValueError(f"elem_sz must be 1 or 2, got {elem_sz}")
    check_args("pack_rows", errs_zz.device, errs_zz=(errs_zz, torch.int32),
               widths=(widths, torch.int32))
    if (errs_zz.dim() != 3 or errs_zz.shape[1] != BLOCK_SZ
            or tuple(widths.shape) != (errs_zz.shape[0], errs_zz.shape[2])):
        raise ValueError(f"pack_rows: errs {tuple(errs_zz.shape)} and widths "
                         f"{tuple(widths.shape)} are not (nb, 8, D), (nb, D)")
    if errs_zz.device.type == "cpu":
        return pack_rows_plain(errs_zz, widths, elem_sz)
    nb, _, ndims = errs_zz.shape
    out = torch.empty((nb, BLOCK_SZ, ndims * elem_sz), dtype=torch.uint8,
                      device=errs_zz.device)
    if nb == 0 or ndims == 0:
        return out
    tile_rows = pack_tile_rows(ndims, elem_sz)
    if errs_zz.data_ptr() % 16:  # the kernel loads 16 bytes at a time
        errs_zz = errs_zz.clone()
    _build.launch("sprintz_pack_rows", errs_zz, errs_zz.data_ptr(),
                  widths.data_ptr(), out.data_ptr(), nb, ndims, elem_sz,
                  tile_rows)
    pack_rows.launches += 1
    return out


pack_rows.launches = 0


# ------------------------------------------------------------------ K4


def unpack_rows_plain(dense: torch.Tensor, widths: torch.Tensor,
                      narrow: bool = False) -> torch.Tensor:
    """Plain version of ``unpack_rows``."""
    fields = extract_fields(dense, widths)
    return fields.to(torch.uint8) if narrow else fields


def unpack_rows(dense: torch.Tensor, widths: torch.Tensor,
                narrow: bool = False) -> torch.Tensor:
    """dense (nb, 8, MAXB) uint8, widths (nb, D) int32 -> zigzag fields
    (nb, 8, D) int32, or uint8 with ``narrow=True``. Bytes at or past MAXB
    read as zero; the 3-byte window serves u8 and u16 streams alike.

    ``narrow=True`` is for u8 streams only: their 3-bit headers decode to
    widths of at most 8 (``bitmath.header_to_width``), so every field fits
    a byte. A wider field would be cut to its low byte; the wrapper does
    not read the widths back to check."""
    check_payload("unpack_rows", dense, widths)
    if dense.device.type == "cpu":
        return unpack_rows_plain(dense, widths, narrow)
    nb, _, maxb = dense.shape
    ndims = widths.shape[1]
    out = torch.empty((nb, BLOCK_SZ, ndims),
                      dtype=torch.uint8 if narrow else torch.int32,
                      device=dense.device)
    if nb == 0 or ndims == 0:
        return out
    off = torch.cumsum(widths, dim=1, dtype=torch.int32) - widths
    _build.launch("sprintz_unpack_zz", dense, dense.data_ptr(),
                  widths.data_ptr(), off.data_ptr(), out.data_ptr(), None, nb,
                  ndims, maxb, TILE_BLOCKS, 8 if narrow else 16, 1)
    if narrow:
        unpack_rows.narrow_launches += 1
    else:
        unpack_rows.launches += 1
    return out


unpack_rows.launches = 0  # K4
unpack_rows.narrow_launches = 0  # K5
