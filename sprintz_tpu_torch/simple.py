"""The non-RLE codecs: bitpack-only ("raw"), "delta" and the legacy "xff".

Counterpart of ``sprintz_tpu/golden/stream.py``'s ``IdentityPredictor``
(:148-164), ``make_predictor`` (:166-178), ``compress_simple`` (:192-246)
and ``decompress_simple`` (:249-291): the reference's sprintz_delta.cpp
(:64-381, :777-1010) and sprintz_xff.cpp (:34-300). Every group emits its
two blocks, zero-width or not: no run machinery. A stream opens with the
6-byte {u32 len, u16 ndims} header, the legacy xff codec's with its 8-byte
{u48 len, u16 ndims} one (``stream_format``), and ends with the verbatim
tail: the elements past the last whole group, partial rows included.
Streams shorter than ``MIN_DATA_SIZE`` elements are stored verbatim. Only
the row-major block layout exists here (the JAX package's default and the
only one its callers pass).

The JAX package loops over blocks in Python; here the codecs run as the
RLE codecs of ``encoder`` / ``decoder`` do, on the card:

- encode: the forecast over the ``ngroups * 16`` rows of whole groups
  (none for "raw": the values are the fields, no zigzag; ``delta_encode``;
  ``fire_encode`` with the truncated coefficient for "xff"), then
  ``encoder.encode_errors`` (widths, header fields and K3 ``pack_rows``);
  on the host, a plan whose slots are all data blocks (a block of zero
  errors is emitted at width 0 with no payload) and
  ``encoder.assemble_stream`` with the simple header in place of the RLE
  metadata.
- decode: the host walk with ``runs=False`` (a zero header is a block of
  width 0, not a run marker) and the payload gather, then on the card K1 +
  K2 (``decode_delta_contiguous``) for "delta", K4 ``unpack_rows`` (K5 at
  u8) for "raw", and K5 / K4 + ``fire_decode`` for "xff".

``device`` is where the device pass runs, CUDA by default (raises when
CUDA is absent); ``"cpu"`` runs the kernels' plain versions (tests).
"""

from __future__ import annotations

import numpy as np
import torch

from . import decoder as _decoder
from . import encoder as _encoder
from .constants import (
    BLOCK_SZ,
    GROUP_SZ_BLOCKS,
    METADATA_LEN_SIMPLE,
    METADATA_LEN_XFF,
    MIN_DATA_SIZE,
)
from .device import resolve_device
from .errors import CorruptStreamError
from .models.forecasters import delta_encode, fire_decode, fire_encode
from .ops.bitmath import zigzag_decode
from .ops.decode_kernels import decode_delta_contiguous, narrow
from .ops.pack_kernels import unpack_rows
from .planner import KIND_DATA, EmissionPlan
from .stream_format import (
    read_metadata_simple,
    read_metadata_xff,
    write_metadata_simple,
    write_metadata_xff,
)

CODECS = ("raw", "delta", "xff")


def _udt(elem_sz: int):
    return np.uint8 if elem_sz == 1 else np.uint16


class IdentityPredictor:
    """Bitpack-only codec: values pass through unmodified (no zigzag)."""

    def __init__(self, ndims: int, elem_sz: int, block_sz: int = BLOCK_SZ):
        self.ndims = ndims
        self.udt = _udt(elem_sz)
        self.block_sz = block_sz

    def encode_block(self, block: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(block, dtype=self.udt)

    def decode_block(self, errs: np.ndarray) -> np.ndarray:
        return errs.astype(self.udt)

    def decode_run(self, nblocks: int) -> np.ndarray:
        return np.zeros((nblocks * self.block_sz, self.ndims), dtype=self.udt)


class DeltaPredictor:
    """Per-dim delta coding a block at a time, on the host: the
    counterpart of the JAX package's golden ``DeltaPredictor``
    (``delta_encode`` from the block before's last row)."""

    def __init__(self, ndims: int, elem_sz: int, block_sz: int = BLOCK_SZ):
        self.ndims = ndims
        self.eb = 8 * elem_sz
        self.udt = _udt(elem_sz)
        self.block_sz = block_sz
        self.prev_vals = np.zeros(ndims, dtype=self.udt)

    def encode_block(self, block: np.ndarray) -> np.ndarray:
        block = np.ascontiguousarray(block, dtype=self.udt)
        zz = delta_encode(torch.from_numpy(block.astype(np.int32)), self.eb,
                          torch.from_numpy(self.prev_vals.astype(np.int32)))
        self.prev_vals = block[-1].copy()
        return zz.numpy().astype(self.udt)

    def decode_block(self, errs: np.ndarray) -> np.ndarray:
        deltas = zigzag_decode(torch.from_numpy(
            np.asarray(errs).astype(np.int64)), self.eb)
        prev = torch.from_numpy(self.prev_vals.astype(np.int64))
        vals = ((torch.cumsum(deltas, dim=0) + prev)
                & ((1 << self.eb) - 1)).numpy().astype(self.udt)
        self.prev_vals = vals[-1].copy()
        return vals

    def decode_run(self, nblocks: int) -> np.ndarray:
        # zero deltas: every row repeats the previous row
        return np.tile(self.prev_vals, (nblocks * self.block_sz, 1))


class FirePredictor:
    """FIRE a block at a time, on the host: the counterpart of the JAX
    package's golden ``FirePredictor``, through ``fire_encode`` /
    ``fire_decode``'s plain versions from the carry the block before
    left."""

    def __init__(self, ndims: int, elem_sz: int, truncate_coeffs: bool = True):
        self.ndims = ndims
        self.eb = 8 * elem_sz
        self.udt = _udt(elem_sz)
        self.truncate_coeffs = truncate_coeffs
        self.state = np.zeros((3, ndims), dtype=np.int32)

    def encode_block(self, block: np.ndarray) -> np.ndarray:
        rows = torch.from_numpy(np.asarray(block).astype(np.int32))
        zz, fin = fire_encode(rows, self.eb, self.truncate_coeffs,
                              init_state=self.state, final=True)
        self.state = fin.numpy()
        return zz.numpy().astype(self.udt)

    def decode_block(self, errs_zz: np.ndarray) -> np.ndarray:
        errs = torch.from_numpy(np.ascontiguousarray(errs_zz).astype(
            np.uint8 if self.eb == 8 else np.int32))
        vals, fin = fire_decode(errs, self.eb, self.state,
                                self.truncate_coeffs, final=True)
        self.state = fin.numpy()
        return _decoder.download_values(vals).reshape(-1, self.ndims)

    def decode_run(self, nblocks: int) -> np.ndarray:
        return self.decode_block(
            np.zeros((nblocks * BLOCK_SZ, self.ndims), dtype=self.udt))


def make_predictor(codec: str, ndims: int, elem_sz: int, lowdim: bool = False,
                   block_sz: int = BLOCK_SZ):
    """A block predictor of ``codec``, on the host as the JAX package's
    are. Lowdim FIRE uses the full-precision coefficient, row-major FIRE
    the truncated one (sprintz_xff_lowdim.cpp:38-39 vs
    sprintz_xff_rle.cpp:209-221)."""
    if codec == "raw":
        return IdentityPredictor(ndims, elem_sz, block_sz=block_sz)
    if codec == "delta":
        return DeltaPredictor(ndims, elem_sz, block_sz=block_sz)
    if codec == "xff":
        if block_sz != BLOCK_SZ:
            raise ValueError("FIRE's learning constants are tied to 8-row "
                             "blocks")
        return FirePredictor(ndims, elem_sz, truncate_coeffs=not lowdim)
    raise ValueError(f"unknown codec {codec!r}")


def _check_layout(layout) -> None:
    if layout != "rowmajor":
        raise ValueError(f"the non-RLE codecs take the row-major layout, "
                         f"not {layout!r}")


def compress_simple(src: np.ndarray, ndims: int, codec: str,
                    layout: str = "rowmajor", write_size: bool = True,
                    device: str | torch.device | None = None) -> bytes:
    """Compress a flat u8/u16 stream of ``ndims`` dims with a non-RLE codec
    (``"raw"``, ``"delta"`` or ``"xff"``); byte-identical to the JAX
    package's ``compress_simple``. ``write_size=False`` leaves the header
    out."""
    _check_layout(layout)
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}")
    src = np.ascontiguousarray(src).reshape(-1)
    if src.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"expected a uint8 or uint16 stream, got {src.dtype}")
    if ndims < 1:
        raise ValueError(f"ndims must be >= 1, got {ndims}")
    elem_sz = src.dtype.itemsize
    n = src.size
    write = write_metadata_xff if codec == "xff" else write_metadata_simple
    head = write(n, ndims) if write_size else b""
    group_elems = BLOCK_SZ * GROUP_SZ_BLOCKS * ndims
    ngroups = n // group_elems if n >= MIN_DATA_SIZE else 0
    if ngroups == 0:
        return head + src.tobytes()
    body = ngroups * group_elems
    rows = _encoder.upload_rows(src[:body].reshape(-1, ndims),
                                resolve_device(device))
    eb = 8 * elem_sz
    if codec == "raw":
        errs = rows
    elif codec == "delta":
        errs = delta_encode(rows, eb)
    else:
        errs = fire_encode(rows, eb, truncate_coeffs=True)
    widths, hdr, dense, wsums = _encoder.encode_errors(errs, elem_sz, False)
    nslots = ngroups * GROUP_SZ_BLOCKS
    plan = EmissionPlan(kinds=np.full(nslots, KIND_DATA, dtype=np.int8),
                        values=np.arange(nslots, dtype=np.int32),
                        ngroups=ngroups, consumed_blocks=nslots,
                        remaining_elems=n - body)
    widths_np, hdr_np, dense_np, wsums_np = _encoder.download_outputs(
        widths, hdr, dense, wsums)
    return _encoder.assemble_stream(
        plan, widths_np, hdr_np, dense_np, ndims, elem_sz, src[body:], False,
        wsums_np, meta=head)


def decompress_simple(buf: bytes, codec: str, layout: str = "rowmajor",
                      elem_sz: int = 1,
                      device: str | torch.device | None = None) -> np.ndarray:
    """Inverse of ``compress_simple``: the flat elements. Raises
    ``CorruptStreamError`` (a ``ValueError``) for a truncated or
    inconsistent stream."""
    _check_layout(layout)
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}")
    if elem_sz not in (1, 2):
        raise ValueError(f"elem_sz must be 1 or 2, got {elem_sz}")
    head = METADATA_LEN_XFF if codec == "xff" else METADATA_LEN_SIMPLE
    if len(buf) < head:
        raise CorruptStreamError(f"stream shorter than its {head}-byte "
                                 f"header ({len(buf)} bytes)")
    read = read_metadata_xff if codec == "xff" else read_metadata_simple
    n, ndims = read(buf)
    udt = _udt(elem_sz)
    if n >= MIN_DATA_SIZE and ndims == 0:
        raise CorruptStreamError("header declares 0 dims")
    group_elems = BLOCK_SZ * GROUP_SZ_BLOCKS * ndims
    ngroups = n // group_elems if n >= MIN_DATA_SIZE else 0
    pos = head
    idx = None
    if ngroups:
        idx = _decoder.walk_headers(buf, ngroups, ndims, elem_sz, start=head,
                                    runs=False)
        pos = idx.tail_offset
    remaining = n - ngroups * group_elems
    if pos + remaining * elem_sz > len(buf):
        raise CorruptStreamError(
            f"verbatim tail truncated: need {pos + remaining * elem_sz} "
            f"bytes, have {len(buf)}")
    tail = np.frombuffer(buf, dtype=udt, count=remaining, offset=pos)
    if idx is None:
        return tail.copy()
    dense, widths, _ = _decoder.upload_payload(
        _decoder.gather_payloads(buf, idx), idx, resolve_device(device))
    eb = 8 * elem_sz
    if codec == "delta":
        vals = decode_delta_contiguous(dense, widths, eb)
    elif codec == "raw":
        vals = unpack_rows(dense, widths, narrow=elem_sz == 1)
        if elem_sz == 2:
            vals = narrow(vals, eb)
    else:
        vals = fire_decode(_decoder.fire_errors(dense, widths, elem_sz, False),
                           eb, truncate_coeffs=True)
    return _decoder.join_tail(_decoder.download_values(vals), tail)
