"""Per-column codec chain protocol and the codec zoo.

The port's copy of ``sprintz_tpu/frames/codecs.py``: every codec's output
and header are the JAX package's (JSON-able, the same keys and values), so
a frame encoded by either package decodes in the other. Capability parity
with the reference's codec.py (BaseCodec:41-185 and the zoo at
:242-732): codecs transform columns in place and return per-column
headers needed for inversion; chains compose left-to-right on encode and
invert in reverse order. Unlike the reference (whose Delta truncates to
i8 as a research hack), these are lossless for all integer widths.

Every codec is numpy on the host but ``Sprintz``, which runs the port's
codec (``SprintzCodec``) on a u8 / u16 column: the lowdim layout at D 1 on
the card (``device``: CUDA by default; ``"cpu"`` for tests).
"""

from __future__ import annotations

import abc
import bz2 as _bz2
import lzma as _lzma
import zlib as _zlib

import numpy as np

from ..api import SprintzCodec
from ..models import online as _online


def _is_numeric(dtype) -> bool:
    return np.issubdtype(dtype, np.integer) or np.issubdtype(
        dtype, np.floating)


class Codec(abc.ABC):
    """One link of a codec chain.

    ``cols(df)`` selects applicable columns; ``train(df)`` may fit state;
    ``encode_col``/``decode_col`` transform one column and round-trip a
    JSON-able header.
    """

    cols_filter = staticmethod(_is_numeric)

    def cols(self, df):
        return [c for c in df.columns if self.cols_filter(df[c].dtype)]

    def train(self, df):
        pass

    @abc.abstractmethod
    def encode_col(self, vals: np.ndarray, col: str):
        ...

    @abc.abstractmethod
    def decode_col(self, vals: np.ndarray, col: str, header):
        ...

    def name(self) -> str:
        return type(self).__name__


def _signed_view(vals: np.ndarray) -> np.ndarray:
    if np.issubdtype(vals.dtype, np.unsignedinteger):
        return vals.view(np.dtype(vals.dtype.name.replace("u", "", 1)))
    return vals


class Delta(Codec):
    """First differences with wraparound (codec.py:242-253)."""

    cols_filter = staticmethod(lambda dt: np.issubdtype(dt, np.integer))

    def encode_col(self, vals, col):
        out = vals.copy()
        out[1:] = vals[1:] - vals[:-1]
        return out, None

    def decode_col(self, vals, col, header):
        return np.cumsum(vals.astype(np.int64)).astype(vals.dtype)


class DoubleDelta(Codec):
    """Second differences (codec.py:256-266)."""

    cols_filter = staticmethod(lambda dt: np.issubdtype(dt, np.integer))

    def encode_col(self, vals, col):
        d = Delta()
        out, _ = d.encode_col(vals, col)
        out2, _ = d.encode_col(out, col)
        return out2, None

    def decode_col(self, vals, col, header):
        d = Delta()
        return d.decode_col(d.decode_col(vals, col, None), col, None)


class DynamicDelta(Codec):
    """Per-block delta vs double-delta choice (codec.py:269-414), using
    the online subsystem's choices-bitfield format for u16 columns and a
    plain delta fallback otherwise."""

    cols_filter = staticmethod(lambda dt: np.issubdtype(dt, np.integer))

    def encode_col(self, vals, col):
        if vals.dtype == np.uint16:
            errs, choices = _online.dynamic_delta_zigzag_encode(vals)
            return errs.view(np.uint16), {
                "mode": "u16", "choices": choices.tobytes().hex()}
        out, _ = Delta().encode_col(vals, col)
        return out, {"mode": "delta"}

    def decode_col(self, vals, col, header):
        if header["mode"] == "u16":
            choices = np.frombuffer(
                bytes.fromhex(header["choices"]), dtype=np.uint8)
            return _online.dynamic_delta_zigzag_decode(
                vals.view(np.int16), choices)
        return Delta().decode_col(vals, col, None)


class Zigzag(Codec):
    """Map signed residues to small unsigned values (codec.py:667-685)."""

    cols_filter = staticmethod(lambda dt: np.issubdtype(dt, np.integer))

    def encode_col(self, vals, col):
        s = _signed_view(vals)
        bits = 8 * vals.dtype.itemsize
        wide = s.astype(np.int64)
        zz = ((wide << 1) ^ (wide >> (bits - 1))) & ((1 << bits) - 1)
        return zz.astype(np.dtype(f"uint{bits}")), vals.dtype.name

    def decode_col(self, vals, col, header):
        u = vals.astype(np.uint64)
        s = (u >> 1) ^ (-(u & 1) & 0xFFFFFFFFFFFFFFFF)
        bits = 8 * vals.dtype.itemsize
        return (s & ((1 << bits) - 1)).astype(np.dtype(header))


class ByteShuffle(Codec):
    """Transpose the byte planes of each column (codec.py:418-436)."""

    cols_filter = staticmethod(
        lambda dt: np.issubdtype(dt, np.integer) and np.dtype(dt).itemsize > 1)

    def encode_col(self, vals, col):
        b = vals.view(np.uint8).reshape(vals.size, vals.dtype.itemsize)
        return np.ascontiguousarray(b.T).reshape(-1).view(np.uint8), \
            vals.dtype.name

    def decode_col(self, vals, col, header):
        dt = np.dtype(header)
        b = vals.view(np.uint8).reshape(dt.itemsize, -1)
        return np.ascontiguousarray(b.T).reshape(-1).view(dt)


class Quantize(Codec):
    """Lossless base-10 float -> uint quantization (codec.py:604-664,
    dfquantize2.py)."""

    cols_filter = staticmethod(lambda dt: np.issubdtype(dt, np.floating))

    def __init__(self, mode: str = "lossless_base10"):
        self.mode = mode

    def encode_col(self, vals, col):
        from .quantize import infer_qparams
        from .quantize import quantize as _quantize

        p = infer_qparams(vals, mode=self.mode)
        if p is None:
            return vals, None  # not quantizable; pass through
        return _quantize(vals, p), dataclasses_to_dict(p)

    def decode_col(self, vals, col, header):
        from .quantize import QuantizeParams, dequantize

        if header is None:
            return vals
        return dequantize(vals, QuantizeParams(**header))


def dataclasses_to_dict(p):
    import dataclasses

    return dataclasses.asdict(p)


class Sprintz(Codec):
    """Wrap a column in the core Sprintz codec (the framework's own
    contribution to the zoo: columns become compressed byte payloads)."""

    cols_filter = staticmethod(
        lambda dt: np.dtype(dt) in (np.uint8, np.uint16))

    def __init__(self, codec: str = "delta", device=None):
        self.codec = codec
        self.device = device

    def encode_col(self, vals, col):
        sc = SprintzCodec(self.codec, vals.dtype.itemsize, device=self.device)
        buf = sc.compress(np.ascontiguousarray(vals))
        return np.frombuffer(buf, dtype=np.uint8), vals.dtype.name

    def decode_col(self, vals, col, header):
        dt = np.dtype(header)
        sc = SprintzCodec(self.codec, dt.itemsize, device=self.device)
        return sc.decompress(vals.tobytes()).astype(dt)


class _Bytes(Codec):
    """Base for general-purpose byte codecs (codec.py:688-732)."""

    cols_filter = staticmethod(lambda dt: True)

    def _c(self, b: bytes) -> bytes:
        raise NotImplementedError

    def _d(self, b: bytes) -> bytes:
        raise NotImplementedError

    def encode_col(self, vals, col):
        comp = self._c(np.ascontiguousarray(vals).tobytes())
        return np.frombuffer(comp, dtype=np.uint8), vals.dtype.name

    def decode_col(self, vals, col, header):
        return np.frombuffer(self._d(vals.tobytes()), dtype=np.dtype(header))


class Zlib(_Bytes):
    def _c(self, b):
        return _zlib.compress(b, 6)

    def _d(self, b):
        return _zlib.decompress(b)


class Bz2(_Bytes):
    def _c(self, b):
        return _bz2.compress(b, 9)

    def _d(self, b):
        return _bz2.decompress(b)


class Lzma(_Bytes):
    def _c(self, b):
        return _lzma.compress(b)

    def _d(self, b):
        return _lzma.decompress(b)


class CodecSearch(Codec):
    """Trainable per-column chain search (codec.py:439-535): tries each
    candidate chain on a training sample and records the winner. A chain
    that cannot take the column (``TypeError`` / ``ValueError``) is
    skipped; any other error (a missing card, say) propagates."""

    cols_filter = staticmethod(lambda dt: np.issubdtype(dt, np.integer))

    def __init__(self, candidates=None):
        self.candidates = candidates or [
            [Delta(), Zigzag()],
            [DoubleDelta(), Zigzag()],
            [Zigzag()],
            [ByteShuffle()],
            [],
        ]
        self._choice: dict[str, int] = {}

    def train(self, df):
        for col in self.cols(df):
            vals = df[col].to_numpy()
            best, best_sz = 0, float("inf")
            for i, chain in enumerate(self.candidates):
                v = vals
                try:
                    for c in chain:
                        v, _ = c.encode_col(v, col)
                    sz = len(_zlib.compress(
                        np.ascontiguousarray(v).tobytes(), 1))
                except (TypeError, ValueError):
                    continue
                if sz < best_sz:
                    best, best_sz = i, sz
            self._choice[col] = best

    def encode_col(self, vals, col):
        idx = self._choice.get(col, 0)
        headers = []
        v = vals
        for c in self.candidates[idx]:
            v, h = c.encode_col(v, col)
            headers.append(h)
        return v, {"idx": idx, "headers": headers}

    def decode_col(self, vals, col, header):
        idx = header["idx"]
        chain = self.candidates[idx]
        v = vals
        for c, h in zip(reversed(chain), reversed(header["headers"])):
            v = c.decode_col(v, col, h)
        return v


class FrameCodec(Codec):
    """A chain link that reads/writes across columns (frame-level).

    ``encode`` / ``decode`` call ``encode_frame``/``decode_frame`` with
    the full column dict instead of per-column hooks."""

    def encode_col(self, vals, col):  # pragma: no cover - not used
        raise NotImplementedError("frame-level codec")

    def decode_col(self, vals, col, header):  # pragma: no cover
        raise NotImplementedError("frame-level codec")

    @abc.abstractmethod
    def encode_frame(self, cols: dict):
        ...

    @abc.abstractmethod
    def decode_frame(self, cols: dict, header):
        ...


class ColSumPredictor(FrameCodec):
    """Predict one column as the (weighted) sum of others; store the
    residual (codec.py:538-601). Weights: None (plain sum) or one
    scalar/FIR-tap array per summed column."""

    def __init__(self, cols_to_sum, col_to_predict, weights=None):
        self.cols_to_sum = ([cols_to_sum] if isinstance(cols_to_sum, str)
                            else list(cols_to_sum))
        self.col_to_predict = col_to_predict
        self.weights = weights

    def name(self):
        return f"colsum({'+'.join(map(str, self.cols_to_sum))}" \
               f"->{self.col_to_predict})"

    def _predict(self, cols):
        pred = None
        for i, c in enumerate(self.cols_to_sum):
            v = np.asarray(cols[c], dtype=np.float64)
            if self.weights is not None:
                w = np.atleast_1d(np.asarray(self.weights[i], np.float64))
                if w.size > 1:  # FIR taps, 'same' correlation
                    v = np.correlate(v, w, mode="same")
                else:
                    v = v * w[0]
            pred = v if pred is None else pred + v
        return pred

    def encode_frame(self, cols):
        tgt = cols[self.col_to_predict]
        pred = self._predict(cols).astype(tgt.dtype)
        cols[self.col_to_predict] = tgt - pred  # wraps for ints: lossless
        return None

    def decode_frame(self, cols, header):
        tgt = cols[self.col_to_predict]
        pred = self._predict(cols).astype(tgt.dtype)
        cols[self.col_to_predict] = tgt + pred
