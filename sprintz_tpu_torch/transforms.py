"""Standalone preprocessor transforms: delta / doubledelta / xff row-major.

Counterpart of ``sprintz_tpu/transforms.py``: the reference's unpacked
transform entry points in delta.cpp (encode/decode_delta_rowmajor_{8,16}b,
encode/decode_doubledelta_rowmajor_{8,16}b and the _inplace variants) and
predict.cpp (encode/decode_xff_rowmajor_{8,16}b and _inplace). These are
not the sprintz codecs: the output is as long as the input (errors stored
raw at full element width, no bit packing, no zigzag), after the 6-byte
{u32 len, u16 ndims} simple header when ``write_size``.

- delta (delta.cpp:34-120): out[j] = src[j] - src[j-D], the first row
  copied.
- doubledelta (delta.cpp:406-467): the delta transform applied twice.
- xff (predict.cpp:56-300): the preprocessor's FIRE over the leading
  ``nblocks`` 8-row blocks, then plain lag-D delta for the trailing
  elements, partial rows included; ``nblocks`` is clipped by the
  reference's overrun guard (predict.cpp:102-107, ``_xff_nblocks``).

On the device: delta and doubledelta are torch operations (a shifted
subtract; the inverse a wrapping prefix over rows, taken in int64 and
masked, so that no sum overflows however many rows); the xff head runs on
``csrc/fire.cu``'s transform instantiations (``fire_encode`` /
``fire_decode`` with ``transform=True``). The data goes up narrow and
comes back narrow. ``device`` is CUDA by default (raises when CUDA is
absent); ``"cpu"`` runs the kernels' plain versions (tests).
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import BLOCK_SZ, METADATA_LEN_SIMPLE
from .decoder import download_values
from .device import resolve_device
from .encoder import upload_rows
from .models.forecasters import fire_decode, fire_encode
from .ops.decode_kernels import narrow, widen
from .ops.pack_kernels import widen_rows
from .stream_format import read_metadata_simple, write_metadata_simple

_VECTOR_NBYTES = 32  # the AVX2 vector the reference's overrun guard assumes

KINDS = ("delta", "doubledelta", "xff")


def _check(kind: str, dtype) -> int:
    if kind not in KINDS:
        raise ValueError(f"unknown transform kind {kind!r}")
    elem_sz = np.dtype(dtype).itemsize
    if np.dtype(dtype).kind != "u" or elem_sz not in (1, 2):
        raise TypeError(f"transforms take uint8/uint16 data, got {dtype}")
    return elem_sz


def _lag_delta(x: torch.Tensor, ndims: int, eb: int) -> torch.Tensor:
    """out[j] = x[j] - x[j-D] mod 2^eb, the first D elements copied;
    int32 in, int32 out."""
    out = x.clone()
    if x.numel() > ndims:
        out[ndims:] = (x[ndims:] - x[:-ndims]) & ((1 << eb) - 1)
    return out


def _lag_undelta(errs: torch.Tensor, ndims: int, eb: int,
                 base: torch.Tensor | None) -> torch.Tensor:
    """Inverse of ``_lag_delta``: the per-dim prefix over rows, mod 2^eb.
    ``base``: the D values before the first error row (None: the stream's
    start). The sum is taken in int64 and masked: wrapping addition is
    associative, so that equals the serial wrapping sum. Each dim's column
    is scanned as a contiguous row of the transposed grid: a card scans an
    innermost dim in parallel, an outer one a column a thread
    (``probes/transform_probe.py`` times both)."""
    n = errs.numel()
    if n == 0:
        return errs.clone()
    nrows = -(-n // ndims)
    grid = torch.zeros(nrows * ndims, dtype=torch.int64, device=errs.device)
    grid[:n] = errs
    acc = torch.cumsum(grid.reshape(nrows, ndims).t().contiguous(), dim=1).t()
    if base is not None:
        acc = acc + base.to(torch.int64)[None, :]
    return (acc & ((1 << eb) - 1)).reshape(-1)[:n].to(torch.int32)


def _xff_nblocks(n: int, ndims: int, elem_sz: int) -> int:
    """The reference's overrun guard (predict.cpp:102-107): FIRE-code
    only blocks whose trailing vector overrun stays inside the buffer."""
    vector_sz = _VECTOR_NBYTES // elem_sz
    nblocks = (n // ndims) // BLOCK_SZ
    overrun = vector_sz - (ndims % vector_sz)
    trailing = n % (BLOCK_SZ * ndims)
    if overrun > trailing:
        nblocks -= -(-overrun // (BLOCK_SZ * ndims))
        nblocks = max(0, nblocks)
    return nblocks


def _xff_encode(x: torch.Tensor, ndims: int, elem_sz: int) -> torch.Tensor:
    eb = 8 * elem_sz
    n = x.numel()
    head = _xff_nblocks(n, ndims, elem_sz) * BLOCK_SZ * ndims
    if not head:
        return _lag_delta(x, ndims, eb)
    out = torch.empty_like(x)
    out[:head] = fire_encode(x[:head].reshape(-1, ndims), eb,
                             transform=True).reshape(-1)
    if n > head:  # the trailing elements: plain lag-D delta
        out[head:] = (x[head:] - x[head - ndims: n - ndims]) & ((1 << eb) - 1)
    return out


def _xff_decode(errs: torch.Tensor, ndims: int, elem_sz: int) -> torch.Tensor:
    """``errs``: the narrow raw errors -> int32 values."""
    eb = 8 * elem_sz
    n = errs.numel()
    head = _xff_nblocks(n, ndims, elem_sz) * BLOCK_SZ * ndims
    if not head:
        return _lag_undelta(widen_rows(errs), ndims, eb, None)
    vals = widen(fire_decode(errs[:head].reshape(-1, ndims), eb,
                             transform=True))
    if n == head:
        return vals.reshape(-1)
    return torch.cat([vals.reshape(-1),
                      _lag_undelta(widen_rows(errs[head:]), ndims, eb,
                                   vals[-1])])


def _encode_body(flat: np.ndarray, kind: str, ndims: int,
                 device: torch.device) -> np.ndarray:
    elem_sz = flat.dtype.itemsize
    eb = 8 * elem_sz
    x = upload_rows(flat, device)
    if kind == "delta":
        body = _lag_delta(x, ndims, eb)
    elif kind == "doubledelta":
        body = _lag_delta(_lag_delta(x, ndims, eb), ndims, eb)
    else:
        body = _xff_encode(x, ndims, elem_sz)
    return download_values(narrow(body, eb))


def transform_encode(data: np.ndarray, kind: str, ndims: int | None = None,
                     write_size: bool = True,
                     device: str | torch.device | None = None) -> bytes:
    """Encode with a standalone transform; the output bytes are the
    reference's encode_{kind}_rowmajor_{8,16}b's."""
    data = np.ascontiguousarray(data)
    _check(kind, data.dtype)
    if data.ndim == 2:
        ndims = data.shape[1] if ndims is None else ndims
    elif ndims is None:
        ndims = 1
    if ndims < 1:
        raise ValueError(f"ndims must be >= 1, got {ndims}")
    flat = data.reshape(-1)
    body = _encode_body(flat, kind, ndims, resolve_device(device))
    head = write_metadata_simple(flat.size, ndims) if write_size else b""
    return head + body.tobytes()


def transform_decode(buf: bytes, kind: str, elem_sz: int,
                     ndims: int | None = None, n: int | None = None,
                     device: str | torch.device | None = None) -> np.ndarray:
    """Decode a ``transform_encode`` stream. With ndims/n omitted, reads the
    6-byte header (the reference's (src, dest) overloads); pass both to
    decode a headerless body (the (src, len, dest, ndims) overloads)."""
    _check(kind, np.uint8 if elem_sz == 1 else np.uint16)
    udt = np.uint8 if elem_sz == 1 else np.uint16
    if ndims is None or n is None:
        n, ndims = read_metadata_simple(buf)
        buf = buf[METADATA_LEN_SIMPLE:]
    errs = np.frombuffer(buf, dtype=udt, count=n)
    if n and ndims < 1:
        raise ValueError(f"ndims must be >= 1, got {ndims}")
    dev = resolve_device(device)
    eb = 8 * elem_sz
    e = upload_rows(errs, dev, narrow=True)
    if kind == "xff":
        vals = _xff_decode(e, ndims, elem_sz)
    else:
        vals = _lag_undelta(widen_rows(e), ndims, eb, None)
        if kind == "doubledelta":
            vals = _lag_undelta(vals, ndims, eb, None)
    return download_values(narrow(vals, eb))


def transform_decode_inplace(buff: np.ndarray, n: int, ndims: int,
                             kind: str,
                             device: str | torch.device | None = None
                             ) -> np.ndarray:
    """decode_{kind}_rowmajor_inplace_{8,16}b: the first n elements of
    ``buff`` hold transform output; they are replaced with the decoded
    values (returned as a view of buff)."""
    elem_sz = _check(kind, buff.dtype)
    out = transform_decode(buff[:n].tobytes(), kind, elem_sz, ndims=ndims,
                           n=n, device=device)
    buff[:n] = out
    return buff[:n]
