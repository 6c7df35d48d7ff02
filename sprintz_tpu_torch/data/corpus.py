"""Dataset layer: quantization, benchmark binary layout, synthetic corpora.

The port's copy of ``sprintz_tpu/data/corpus.py`` (numpy, host): the same
corpora, bit for bit, from the same seeds.

Mirrors the reference's evaluation pipeline (python/datasets/
compress_bench.py:45-157): float data is quantized per column to the full
u8/u16 range and dumped as flat binaries under
``{rowmajor,colmajor}/uint{8,16}/<dataset>/*.dat`` (README.md:43-46).

The real corpora (UCR-85, MSRC-12, PAMAP, UCI-Gas, AMPDs) are external
downloads; in an offline environment ``synthetic_corpus`` generates
streams with matching statistical profiles (dimensionality, smoothness,
run structure) so ratio/throughput benchmarks remain meaningful, and
``load_dataset`` transparently prefers real data when a corpus directory
exists.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np


def quantize(mat: np.ndarray, dtype=np.uint8, axis: int = 0) -> np.ndarray:
    """Per-column min/max quantization to the full dtype range
    (compress_bench.py:45-60)."""
    mat = np.asarray(mat, dtype=np.float64)
    mat = mat - np.min(mat, axis=axis, keepdims=True)
    denom = np.maximum(1e-20, np.max(mat, axis=axis, keepdims=True))
    mat = mat / denom
    max_val = 255 if np.dtype(dtype) == np.uint8 else 65535
    return (mat * max_val).astype(dtype)


def write_dat(root: str | pathlib.Path, name: str, mat: np.ndarray,
              order: str = "c") -> pathlib.Path:
    """Write the benchmark layout: <root>/<order>major/<dtype>/<name>.dat."""
    mat = np.asarray(mat)
    layout = "rowmajor" if order == "c" else "colmajor"
    d = pathlib.Path(root) / layout / str(mat.dtype) / name
    d.parent.mkdir(parents=True, exist_ok=True)
    data = mat if order == "c" else np.asfortranarray(mat).T
    pathlib.Path(str(d) + ".dat").write_bytes(
        np.ascontiguousarray(data).tobytes())
    return pathlib.Path(str(d) + ".dat")


def read_dat(path: str | pathlib.Path, dtype, ndims: int = 1) -> np.ndarray:
    flat = np.frombuffer(pathlib.Path(path).read_bytes(), dtype=dtype)
    n = (flat.size // ndims) * ndims
    return flat[:n].reshape(-1, ndims)


# ---------------------------------------------------------------- synthetic

# (ndims, profile) per evaluation corpus; dims from the reference papers:
# MSRC-12 Kinect 80 dims, PAMAP 31, UCI-Gas 16+2, AMPDs power/gas/water.
CORPUS_PROFILES = {
    "ucr_like": dict(ndims=1, kind="smooth", scale=8.0),
    "msrc12_like": dict(ndims=80, kind="smooth", scale=4.0),
    "pamap_like": dict(ndims=31, kind="mixed", scale=16.0),
    "uci_gas_like": dict(ndims=18, kind="smooth", scale=32.0),
    "ampd_like": dict(ndims=3, kind="steps", scale=64.0),
}


def synthetic_corpus(name: str, nrows: int = 100_000, dtype=np.uint8,
                     seed: int = 0) -> np.ndarray:
    """Generate a (nrows, ndims) quantized stream with a corpus-like profile."""
    prof = CORPUS_PROFILES[name]
    rng = np.random.default_rng(seed)
    nd = prof["ndims"]
    t = np.arange(nrows)[:, None]
    if prof["kind"] == "smooth":
        base = np.cumsum(rng.normal(0, prof["scale"], (nrows, nd)), axis=0)
        base += 40 * np.sin(2 * np.pi * t / rng.integers(50, 500, nd))
    elif prof["kind"] == "mixed":
        base = np.cumsum(rng.normal(0, prof["scale"], (nrows, nd)), axis=0)
        spikes = rng.random((nrows, nd)) < 0.01
        base += spikes * rng.normal(0, 20 * prof["scale"], (nrows, nd))
    elif prof["kind"] == "steps":
        # appliance-style: long constant runs with occasional level shifts
        switch = rng.random((nrows, nd)) < 0.002
        levels = rng.normal(0, prof["scale"], (nrows, nd)) * switch
        base = np.cumsum(levels, axis=0)
    else:
        raise ValueError(prof["kind"])
    return quantize(base, dtype=dtype)


def load_dataset(name: str, dtype=np.uint8, nrows: int = 100_000,
                 data_dir: str | None = None, seed: int = 0) -> np.ndarray:
    """Load a real corpus if available, else its synthetic stand-in.

    Real data is searched under ``$SPRINTZ_DATA_DIR`` (or ``data_dir``) in
    the reference's {rowmajor}/{dtype}/<name>/ layout.
    """
    root = data_dir or os.environ.get("SPRINTZ_DATA_DIR")
    base = name.removesuffix("_like")
    if root:
        d = pathlib.Path(root) / "rowmajor" / np.dtype(dtype).name
        for cand in [d / base, d / name]:
            if cand.is_dir():
                files = sorted(cand.glob("*.dat"))
                if files:
                    ndims = CORPUS_PROFILES.get(name, {}).get("ndims", 1)
                    return np.concatenate(
                        [read_dat(f, dtype, ndims) for f in files])
    return synthetic_corpus(name, nrows=nrows, dtype=dtype, seed=seed)
