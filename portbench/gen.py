"""Inputs from the seed: the benchmark's frozen copy of the synthetic
corpus generator of ``sprintz_tpu_torch/data/corpus.py``
(``CORPUS_PROFILES``, ``synthetic_corpus``, ``quantize``), so that a later
change to the program cannot change what the benchmark feeds it.

The profiles stand in for the paper's evaluation corpora (UCR, MSRC-12,
PAMAP, UCI-Gas, AMPds), which are downloads: dimensionality, smoothness
and run structure as there, quantized per column to the full u8 / u16
range as the reference's ``python/datasets/compress_bench.py`` does.

One profile is the benchmark's own, not the port's: ``ampd_gas_like``
(kind ``meter``), a whole-house gas meter's three minutely columns as
AMPds2 records them (counter, avg_rate, inst_rate). A burner cycles on
and off (geometric stretches, ``on_rows`` and ``off_rows`` on average), at
a rate of its own each time it fires and a little noise while it burns;
``inst_rate`` is that rate, ``avg_rate`` its mean over the last ``window``
rows (ramps up and down at every edge), ``counter`` its running sum.
Idle stretches are constant in all three columns; the ramps are where
FIRE's coefficient learns."""

from __future__ import annotations

import numpy as np

PROFILES = {
    "ucr_like": dict(ndims=1, kind="smooth", scale=8.0),
    "msrc12_like": dict(ndims=80, kind="smooth", scale=4.0),
    "pamap_like": dict(ndims=31, kind="mixed", scale=16.0),
    "uci_gas_like": dict(ndims=18, kind="smooth", scale=32.0),
    "ampd_like": dict(ndims=3, kind="steps", scale=64.0),
    "ampd_gas_like": dict(ndims=3, kind="meter", on_rows=12, off_rows=150,
                          window=16, noise=0.001),
}


def quantize(mat: np.ndarray, dtype) -> np.ndarray:
    """Per-column min/max quantization to the full dtype range."""
    mat = np.asarray(mat, dtype=np.float64)
    mat = mat - np.min(mat, axis=0, keepdims=True)
    mat = mat / np.maximum(1e-20, np.max(mat, axis=0, keepdims=True))
    return (mat * (255 if np.dtype(dtype) == np.uint8 else 65535)).astype(
        dtype)


def synthetic(profile: str, nrows: int, dtype, seed) -> np.ndarray:
    """A (nrows, ndims) stream with the profile's statistics; ``seed`` is
    anything ``np.random.default_rng`` takes."""
    prof = PROFILES[profile]
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
    elif prof["kind"] == "meter":
        base = _meter(rng, nrows, prof)
    else:
        raise ValueError(prof["kind"])
    return quantize(base, dtype)


def _meter(rng, nrows: int, prof: dict) -> np.ndarray:
    """(nrows, 3) float columns counter, avg_rate, inst_rate of a burner
    cycling off and on (module docstring)."""
    mean = prof["on_rows"] + prof["off_rows"]
    n = 2 * (nrows // mean) + 64  # stretches, off first; enough to cover
    while True:
        lens = np.where(np.arange(n) % 2 == 0,
                        rng.geometric(1 / prof["off_rows"], n),
                        rng.geometric(1 / prof["on_rows"], n))
        if lens.sum() >= nrows:
            break
        n *= 2
    stretch = np.repeat(np.arange(n), lens)[:nrows]  # each row's stretch
    rate = rng.uniform(0.6, 1.0, n)[stretch]  # its burner rate
    on = stretch % 2 == 1
    inst = np.where(on, rate + rng.normal(0, prof["noise"], nrows), 0.0)
    w = prof["window"]
    total = np.concatenate([np.zeros(w), np.cumsum(inst)])
    avg = (total[w:] - total[:-w]) / w
    return np.stack([total[w:], avg, inst], axis=1)
