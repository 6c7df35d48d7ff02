"""The filter-bank search in the PyTorch port
(``sprintz_tpu_torch/models/learning.py``) against the JAX package's
``greedy_brute_filters``, on the same numpy-seeded signals,
``device="cpu"``.

Tolerance: the filters are equal wherever the round's two best candidates'
means differ by more than 1e-4 relative; where they do not, the port's
pick's mean lies within 1e-4 (relative) of JAX's, both recomputed in
float64 (``candidate_means_plain``), and the later rounds, which start
from other filters, are not compared. Cases follow
``tests/test_learning.py``."""

import numpy as np
import pytest
import torch

from sprintz_tpu.models import learning as jl
from sprintz_tpu_torch.models import learning as pl

RTOL = 1e-4


def walk(seed: int, n: int) -> np.ndarray:
    return np.cumsum(np.random.default_rng(seed).normal(0, 1, n)).astype(
        np.float32)


def assert_same_picks(got, want, x, ntaps, nbits, step_sz, block_sz, loss,
                      max_samples=1 << 16):
    cands = pl.all_possible_filters(ntaps, nbits, step_sz)
    for i, (g, w) in enumerate(zip(got, want)):
        if np.array_equal(g, w):
            continue
        means = pl.candidate_means_plain(x, want[:i], cands, ntaps, block_sz,
                                         loss, max_samples)
        mg = means[np.flatnonzero((cands == g).all(axis=1))[0]]
        mw = means[np.flatnonzero((cands == w).all(axis=1))[0]]
        assert abs(mg - mw) <= RTOL * abs(mw), (i, g, w, mg, mw)
        return


@pytest.mark.parametrize("loss,block_sz", [
    ("l2", 1), ("l2", 4), ("l1", 1), ("linf", 4), ("l1", 8), ("linf", 8)])
def test_matches_jax(loss, block_sz):
    x = walk(123 + block_sz, 600)
    kw = dict(nfilters=3, ntaps=2, nbits=3, step_sz=0.5, block_sz=block_sz,
              loss=loss, chunk=16)
    got, objective, round_s = pl.greedy_search(x, device="cpu", **kw)
    assert round_s.shape == (3,) and (round_s > 0).all()
    want = jl.greedy_brute_filters(x, **kw)
    assert got.shape == want.shape == (3, 2) and got.dtype == np.float32
    assert_same_picks(got, want, x, 2, 3, 0.5, block_sz, loss)
    # each round's objective is the float64 recomputation's minimum
    cands = pl.all_possible_filters(2, 3, 0.5)
    for i in range(3):
        means = pl.candidate_means_plain(x, got[:i], cands, 2, block_sz, loss)
        np.testing.assert_allclose(objective[i], means.min(), rtol=RTOL)


@pytest.mark.parametrize("chunk", [48, 512])
def test_chunks_and_sample_cap_match_jax(chunk):
    """A chunk that does not divide the grid (its padded candidates are
    dropped) and a signal longer than max_samples."""
    x = walk(7, 3000)
    kw = dict(nfilters=2, ntaps=3, nbits=3, step_sz=0.25, block_sz=8,
              loss="l2", chunk=chunk, max_samples=1000)
    got = pl.greedy_brute_filters(x, device="cpu", **kw)
    assert_same_picks(got, jl.greedy_brute_filters(x, **kw), x, 3, 3, 0.25,
                      8, "l2", max_samples=1000)


def test_learns_delta_for_random_walk():
    """On a pure random walk the best 2-tap predictor is 'previous
    value' (delta coding: taps [0, 1])."""
    x = walk(123, 4000)
    f = pl.greedy_brute_filters(x, nfilters=1, ntaps=2, nbits=3,
                                step_sz=0.5, block_sz=8, chunk=64,
                                device="cpu")
    np.testing.assert_array_equal(f[0], [0.0, 1.0])


@pytest.mark.parametrize("ntaps,nbits,step_sz", [
    (2, 2, 0.5), (3, 3, 0.25), (4, 4, 0.5), (1, 4, 0.125)])
def test_candidate_grid_matches_jax(ntaps, nbits, step_sz):
    got = pl.all_possible_filters(ntaps, nbits, step_sz)
    want = jl.all_possible_filters(ntaps, nbits, step_sz)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("loss,block_sz", [
    ("l2", 1), ("l2", 5), ("l1", 8), ("linf", 2), ("linf", 7), ("linf", 8)])
def test_block_reduce_matches_jax(loss, block_sz):
    losses = np.abs(np.random.default_rng(block_sz).normal(
        0, 3, (200, 6))).astype(np.float32)
    # the port reduces along the last dim (a candidate a row), JAX dim 0
    got = pl._block_reduce(torch.from_numpy(losses.T.copy()), block_sz,
                           loss).numpy().T
    want = np.asarray(jl._block_reduce(losses, block_sz, loss))
    assert got.shape == want.shape
    if loss == "linf" or block_sz == 1:
        np.testing.assert_array_equal(got, want)
    else:  # float32 cumsums, summed in another order
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        pl.greedy_brute_filters(walk(0, 100), nfilters=1, ntaps=1, nbits=2)
