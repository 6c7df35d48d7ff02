"""Public API: the port's compress/decompress entry points.

Mirrors ``sprintz_tpu/api.py``: the delta and FIRE (xff) codecs, u8 and
u16, at every ndims, in the layout the JAX package picks
(``constants.LOWDIM_MAX_NDIMS``): row-major for u8 ndims > 4 and u16
ndims > 2, lowdim (column-major blocks, FIRE's full-precision
coefficient) below; with RLE of zero blocks, streams short
enough to be stored verbatim, and the +Huf entropy stage on either codec
and layout; checkpoint sidecars (``compress_seekable``,
``decompress(sidecar=)``, and ``checkpoint.decode_range``); and batches of
streams in one device pass (``compress_batch``, ``decompress_batch``).
Nothing falls back to another codec path.

Entry points run on CUDA unless ``device`` says otherwise; ``"cpu"`` runs
the kernels' plain PyTorch versions and is meant for tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import decoder as _decoder
from . import encoder as _encoder
from .checkpoint import Sidecar, compress_with_sidecar, decompress_parallel
from .entropy.huffman import huff_compress, huff_decompress, is_container
from .errors import CorruptStreamError
from .utils.trace import annotate

__all__ = ["CorruptStreamError", "Sidecar", "SprintzCodec", "compress",
           "decompress"]


@dataclasses.dataclass(frozen=True)
class SprintzCodec:
    """A configured Sprintz codec.

    Args:
      codec: "delta" (running difference) or "xff" (FIRE online
        forecaster).
      elem_sz: bytes per element: 1 (uint8) or 2 (uint16).
      entropy: "none" or "huffman" (the paper's "+Huf" variants).
      device: where the device pass runs; None means "cuda".

    ``entropy`` and ``device`` are keyword-only: the JAX package's third
    positional field is ``backend``, so a third positional argument would
    change its meaning between the two packages.
    """

    codec: str = "delta"
    elem_sz: int = 1
    _: dataclasses.KW_ONLY
    entropy: str = "none"
    device: str | torch.device | None = None

    def __post_init__(self):
        if self.codec not in ("delta", "xff"):
            raise ValueError(f"codec must be 'delta' or 'xff', got {self.codec!r}")
        if self.elem_sz not in (1, 2):
            raise ValueError(f"elem_sz must be 1 or 2, got {self.elem_sz}")
        if self.entropy not in ("none", "huffman"):
            raise ValueError(f"unknown entropy stage {self.entropy!r}")

    def _as_flat(self, data: np.ndarray) -> tuple[np.ndarray, int]:
        udt = np.uint8 if self.elem_sz == 1 else np.uint16
        data = np.ascontiguousarray(data)
        if data.dtype != udt:
            raise TypeError(f"expected dtype {udt}, got {data.dtype}")
        if data.ndim == 2:
            return data.reshape(-1), data.shape[1]
        if data.ndim == 1:
            return data, 1
        raise ValueError("data must be 1-D (univariate) or 2-D (rows, dims)")

    @annotate("sprintz.compress")
    def compress(self, data: np.ndarray, ndims: int | None = None) -> bytes:
        """Compress a (rows, ndims) array or flat row-major stream."""
        flat, inferred = self._as_flat(data)
        ndims = inferred if ndims is None else ndims
        stream = _encoder.compress(flat, ndims, codec=self.codec,
                                   elem_sz=self.elem_sz, device=self.device)
        if self.entropy == "huffman":
            return self._entropy_wrap(stream)
        return stream

    def _entropy_wrap(self, stream: bytes) -> bytes:
        """+Huf entropy stage with a zero-overhead stored escape: when
        Huffman coding does not shrink the stream, the plain sprintz
        stream is emitted verbatim (decompress routes on the strict
        container check, ``is_container``). A plain stream that would
        itself parse as a container gets the 12-byte stored wrapper
        instead."""
        coded = huff_compress(stream, device=self.device)
        if len(coded) >= len(stream) and not is_container(stream):
            return stream
        return coded

    @annotate("sprintz.decompress")
    def decompress(self, buf: bytes,
                   sidecar: Sidecar | None = None) -> np.ndarray:
        """Decompress a stream; returns the flat row-major element array.

        ``sidecar``: the checkpoint sidecar ``compress_seekable`` returned
        with the stream; the decode then runs chunk-parallel, each chunk
        from its recorded state (``checkpoint.decompress_parallel``), with
        the sidecar's codec and element size.

        Raises ``CorruptStreamError`` when the buffer is truncated, its
        metadata is inconsistent, or the sidecar does not fit the stream."""
        if self.entropy == "huffman" and is_container(buf):
            buf = huff_decompress(buf, device=self.device).tobytes()
        if sidecar is not None:
            return decompress_parallel(buf, sidecar, device=self.device)
        return _decoder.decompress(buf, codec=self.codec,
                                   elem_sz=self.elem_sz, device=self.device)

    @annotate("sprintz.compress_seekable")
    def compress_seekable(self, data: np.ndarray, ndims: int | None = None,
                          every_groups: int = 16) -> tuple[bytes, Sidecar]:
        """Compress and build a checkpoint sidecar -> (stream, sidecar). The
        stream is ``compress``'s bytes (+Huf wrapped on top as there); the
        sidecar lets ``decompress(stream, sidecar=...)`` decode
        chunk-parallel and ``checkpoint.decode_range`` seek."""
        flat, inferred = self._as_flat(data)
        ndims = inferred if ndims is None else ndims
        stream, sc = compress_with_sidecar(flat, ndims, codec=self.codec,
                                           every_groups=every_groups,
                                           device=self.device)
        if self.entropy == "huffman":
            stream = self._entropy_wrap(stream)
        return stream, sc

    @annotate("sprintz.compress_batch")
    def compress_batch(self, arrays: list[np.ndarray],
                       ndims: int | None = None) -> list[bytes]:
        """Compress S same-shape (rows, ndims) arrays in one device pass
        (``encoder.compress_batch``: the forecast runs S * ndims lanes
        wide); each stream is byte-identical to its own ``compress``.
        Other batches (other shapes, 1-D arrays, an explicit ``ndims``,
        +Huf) and any array whose dtype is not the codec's go through
        ``compress`` one by one, which raises the same ``TypeError`` on a
        wrong dtype."""
        expected = np.dtype(np.uint8 if self.elem_sz == 1 else np.uint16)
        arrays = [np.asarray(a) for a in arrays]
        if (self.entropy == "none" and ndims is None and arrays
                and all(a.ndim == 2 and a.shape == arrays[0].shape
                        and a.dtype == expected for a in arrays)):
            return _encoder.compress_batch(np.stack(arrays),
                                           codec=self.codec,
                                           device=self.device)
        return [self.compress(a, ndims=ndims) for a in arrays]

    @annotate("sprintz.decompress_batch")
    def decompress_batch(self, bufs: list[bytes]) -> list[np.ndarray]:
        """Decompress S streams in one device pass
        (``decoder.decompress_batch``), the counterpart of
        ``compress_batch``; +Huf streams decode one by one."""
        if self.entropy == "none":
            return _decoder.decompress_batch(bufs, codec=self.codec,
                                             elem_sz=self.elem_sz,
                                             device=self.device)
        return [self.decompress(b) for b in bufs]


def compress(
    data: np.ndarray,
    codec: str = "delta",
    ndims: int | None = None,
    device: str | torch.device | None = None,
) -> bytes:
    elem_sz = np.asarray(data).dtype.itemsize
    return SprintzCodec(codec, elem_sz, device=device).compress(
        data, ndims=ndims)


def decompress(
    buf: bytes,
    codec: str = "delta",
    elem_sz: int = 1,
    device: str | torch.device | None = None,
) -> np.ndarray:
    return SprintzCodec(codec, elem_sz, device=device).decompress(buf)
