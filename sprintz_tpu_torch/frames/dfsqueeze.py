"""DataFrame codec-chain entry points (dfsqueeze.py:15-233 capability).

The port's copy of ``sprintz_tpu/frames/dfsqueeze.py``. ``encode(dfs,
codecs)`` applies a trainable chain of column codecs to a collection of
DataFrames and returns per-frame headers; ``decode`` inverts in reverse
order; ``encode_measure_decode`` reports sizes and round-trip correctness.
A frame is anything with ``.columns`` and ``frame[c].to_numpy()``: pandas
is not needed.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _as_dict(dfs):
    if isinstance(dfs, dict):
        return dfs
    return {str(i): df for i, df in enumerate(dfs)}


def encode(dfs, codecs):
    """Train the chain on all frames, then encode each.

    Returns (encoded: dict[name -> dict[col -> ndarray]], headers:
    dict[name -> list[(codec_name, dict[col -> header])]]).
    """
    dfs = _as_dict(dfs)
    for codec in codecs:
        for df in dfs.values():
            codec.train(df)
    encoded = {}
    headers = {}
    for name, df in dfs.items():
        cols = {c: df[c].to_numpy() for c in df.columns}
        frame_headers = []
        for codec in codecs:
            if hasattr(codec, "encode_frame"):
                frame_headers.append((codec.name(),
                                      codec.encode_frame(cols)))
                continue
            applicable = [c for c in cols
                          if codec.cols_filter(cols[c].dtype)]
            col_headers = {}
            for c in applicable:
                cols[c], col_headers[c] = codec.encode_col(cols[c], c)
            frame_headers.append((codec.name(), col_headers))
        encoded[name] = cols
        headers[name] = frame_headers
    return encoded, headers


def decode(encoded, headers, codecs):
    """Invert ``encode``; returns dict[name -> dict[col -> ndarray]]."""
    out = {}
    for name, cols in encoded.items():
        cols = dict(cols)
        for codec, (cname, col_headers) in zip(
                reversed(codecs), reversed(headers[name])):
            assert codec.name() == cname, f"chain mismatch: {codec.name()} != {cname}"
            if hasattr(codec, "decode_frame"):
                codec.decode_frame(cols, col_headers)
                continue
            for c, h in col_headers.items():
                cols[c] = codec.decode_col(cols[c], c, h)
        out[name] = cols
    return out


@dataclasses.dataclass
class MeasureResult:
    orig_nbytes: int
    encoded_nbytes: int
    lossless: bool

    @property
    def ratio(self) -> float:
        return self.orig_nbytes / max(1, self.encoded_nbytes)


def encode_measure_decode(dfs, codecs) -> MeasureResult:
    """Encode, measure sizes, decode, and check equality
    (dfsqueeze.py:133-233)."""
    dfs = _as_dict(dfs)
    orig = sum(int(df[c].to_numpy().nbytes)
               for df in dfs.values() for c in df.columns)
    encoded, headers = encode(dfs, codecs)
    enc_bytes = sum(int(np.ascontiguousarray(v).nbytes)
                    for cols in encoded.values() for v in cols.values())
    decoded = decode(encoded, headers, codecs)
    ok = True
    for name, df in dfs.items():
        for c in df.columns:
            a = df[c].to_numpy()
            b = decoded[name][c]
            same = (np.array_equal(a, b) or
                    (np.issubdtype(a.dtype, np.floating)
                     and np.array_equal(a, b, equal_nan=True)))
            ok &= bool(same)
    return MeasureResult(orig, enc_bytes, ok)
