"""Similarity search and windows in the PyTorch port
(``sprintz_tpu_torch/search.py``, ``windows.py``) against the JAX
package's, on the same numpy-seeded inputs, ``device="cpu"``.

Search: indices equal, ties in ``jax.lax.top_k``'s order (the lower index
first) on data with duplicated rows, distances within abs 1e-3 (the JAX
tests' tolerance; integer data gives them exactly), also with TF32 or
bf16 matmuls switched on globally, which the port must leave as the caller
set them. Windows (float64 numpy in both): equal bit for bit."""

import numpy as np
import pytest
import torch

from sprintz_tpu import search as js
from sprintz_tpu import windows as jw
from sprintz_tpu_torch import search as ps
from sprintz_tpu_torch import windows as pw
from sprintz_tpu_torch.device import exact_fp32_matmul

CPU = "cpu"


@pytest.fixture(scope="module")
def data():
    """Integer rows with planted duplicates, queries on and near them."""
    rng = np.random.default_rng(16)
    X = rng.integers(-40, 41, (257, 24)).astype(np.float32)
    for src, dsts in ((5, (7, 100, 200, 256)), (31, (0, 30, 250))):
        X[list(dsts)] = X[src]
    Q = rng.integers(-40, 41, (9, 24)).astype(np.float32)
    Q[0], Q[1] = X[5], X[31]
    Q[2] = X[5] + np.eye(24, dtype=np.float32)[3]
    Q[3] = X[31] - np.eye(24, dtype=np.float32)[0]
    return X, Q


def idx_dist(lists):
    return ([[n.idx for n in nbs] for nbs in lists],
            [[n.dist for n in nbs] for nbs in lists])


def assert_same_neighbors(got, want):
    gi, gd = idx_dist(got)
    wi, wd = idx_dist(want)
    assert gi == wi
    for a, b in zip(gd, wd):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)


@pytest.mark.parametrize("kind", ["int", "float"])
def test_squared_dists_match_jax(data, kind):
    X, Q = data
    if kind == "float":
        rng = np.random.default_rng(1)
        X, Q = (rng.normal(size=a.shape).astype(np.float32) for a in (X, Q))
    got = ps.squared_dists(X, Q, device=CPU)
    assert got.dtype == torch.float32 and got.shape == (X.shape[0], Q.shape[0])
    want = np.asarray(js.squared_dists(X, Q))
    if kind == "int":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_precomputed_norms(data):
    X, Q = data
    xn = ps.row_norms_sq(X, device=CPU)
    np.testing.assert_array_equal(xn.numpy(), np.asarray(js.row_norms_sq(X)))
    plain = ps.squared_dists(X, Q, device=CPU)
    for norms in (xn, xn.numpy()):
        assert torch.equal(ps.squared_dists(X, Q, x_norms=norms, device=CPU),
                           plain)
    assert_same_neighbors(ps.knn_batch(X, Q, 6, x_norms=xn, device=CPU),
                          js.knn_batch(X, Q, 6))


@pytest.mark.parametrize("k", [1, 4, 10, 300])
def test_knn_batch_matches_jax(data, k):
    X, Q = data
    got = ps.knn_batch(X, Q, k, device=CPU)
    assert_same_neighbors(got, js.knn_batch(X, Q, k))
    assert all(len(nbs) == min(k, X.shape[0]) for nbs in got)


def test_ties_lower_index_first(data):
    """Duplicated rows tie exactly; JAX's order puts the lower index
    first, at the query's own rows and further out."""
    X, Q = data
    got = ps.knn_batch(X, Q[:2], 5, device=CPU)
    assert [n.idx for n in got[0]] == [5, 7, 100, 200, 256]
    assert [n.idx for n in got[1]][:4] == [0, 30, 31, 250]
    same = np.zeros((40, 3), np.float32)
    assert [n.idx for n in ps.knn(same, same[0], 7, device=CPU)] == list(
        range(7))


def test_knn_float_data_matches_jax():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(300, 7)).astype(np.float32)
    Q = rng.normal(size=(5, 7)).astype(np.float32)
    assert_same_neighbors(ps.knn_batch(X, Q, 4, device=CPU),
                          js.knn_batch(X, Q, 4))


def test_single_query_forms_match_jax(data):
    X, Q = data
    for q in Q[:4]:
        assert ps.onenn(X, q, device=CPU) == js.onenn(X, q)
        assert ps.knn(X, q, 3, device=CPU) == js.knn(X, q, 3)
        assert (ps.radius(X, q, 9000.0, device=CPU)
                == js.radius(X, q, 9000.0))
    assert ps.onenn_batch(X, Q, device=CPU) == js.onenn_batch(X, Q)


def test_knn_k_larger_than_n_and_empty():
    X = np.arange(12, dtype=np.float32).reshape(4, 3)
    got = ps.knn(X, X[2], 10, device=CPU)
    assert got == js.knn(X, X[2], 10)
    assert len(got) == 4 and got[0].idx == 2 and got[0].dist == 0.0
    assert ps.knn_batch(X, X[:2], 0, device=CPU) == [[], []]
    assert ps.knn_tiled(X, X[:2], 0, device=CPU) == [[], []]


@pytest.mark.parametrize("tile", [64, 100, 257, 4096])
def test_knn_tiled_matches_jax(data, tile):
    """The running best sits before each tile in the merge: ties across
    tiles keep the earlier (lower) row, as JAX's scan does."""
    X, Q = data
    got = ps.knn_tiled(X, Q, 6, tile_rows=tile, device=CPU)
    assert_same_neighbors(got, js.knn_tiled(X, Q, 6, tile_rows=tile))
    assert_same_neighbors(got, ps.knn_batch(X, Q, 6, device=CPU))


def test_knn_tiled_pad_rows_never_returned():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(7, 5)).astype(np.float32)
    out = ps.knn_tiled(X, X[:2], 7, tile_rows=4, device=CPU)  # pads 7 -> 8
    assert_same_neighbors(out, js.knn_tiled(X, X[:2], 7, tile_rows=4))
    for nbs in out:
        assert len(nbs) == 7
        assert all(0 <= n.idx < 7 for n in nbs)


@pytest.mark.parametrize("radius_sq", [0.5, 3000.0, 9000.0, 1e9])
def test_radius_matches_jax(data, radius_sq):
    X, Q = data
    got = ps.radius_batch(X, Q, radius_sq, device=CPU)
    assert got == js.radius_batch(X, Q, radius_sq)
    mask, d = ps.radius_mask(X, Q, radius_sq, device=CPU)
    jm, jd = js.radius_mask(X, Q, radius_sq)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_neighbors_in_radius_host():
    rng = np.random.default_rng(4)
    d = rng.integers(0, 50, (30, 4)).astype(np.float32)
    assert (ps.neighbors_in_radius(d, radius_sq=20.0)
            == js.neighbors_in_radius(d, radius_sq=20.0))
    m = d < 9
    assert ps.neighbors_in_radius(d, m) == js.neighbors_in_radius(d, m)


def test_torch_inputs(data):
    X, Q = data
    assert (ps.knn_batch(torch.from_numpy(X).double(), torch.from_numpy(Q), 3,
                         device=CPU)
            == ps.knn_batch(X, Q, 3, device=CPU))


def test_entry_points_need_cuda_by_default(data):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    X, Q = data
    for fn in (lambda: ps.squared_dists(X, Q), lambda: ps.knn_batch(X, Q, 2),
               lambda: ps.knn_tiled(X, Q, 2), lambda: ps.radius_batch(X, Q, 1.0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()


def _settings():
    return (torch.backends.cuda.matmul.fp32_precision,
            torch.backends.mkldnn.matmul.fp32_precision,
            torch.backends.fp32_precision)


@pytest.fixture
def restore_precision():
    before = _settings()
    yield before
    torch.set_float32_matmul_precision("highest")
    (torch.backends.cuda.matmul.fp32_precision,
     torch.backends.mkldnn.matmul.fp32_precision,
     torch.backends.fp32_precision) = before
    assert _settings() == before


def _legacy():
    try:
        return (torch.get_float32_matmul_precision(),
                torch.backends.cuda.matmul.allow_tf32)
    except RuntimeError:
        return "mixed"


@pytest.mark.parametrize("switch", ["allow_tf32", "high", "medium",
                                    "cuda_tf32", "all_tf32"])
def test_tf32_switched_on_globally(data, restore_precision, switch):
    """The same answers with the caller's TF32 / bf16 setting, which the
    call leaves as it found it."""
    X, Q = data
    want = ps.knn_batch(X, Q, 5, device=CPU), ps.knn_tiled(
        X, Q, 5, tile_rows=100, device=CPU)
    if switch == "allow_tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
    elif switch in ("high", "medium"):
        torch.set_float32_matmul_precision(switch)
    elif switch == "cuda_tf32":
        torch.backends.cuda.matmul.fp32_precision = "tf32"
    else:
        torch.backends.fp32_precision = "tf32"
    set_ = _settings(), _legacy()
    assert set_[0] != restore_precision
    with exact_fp32_matmul():
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.mkldnn.matmul.fp32_precision == "ieee"
    got = ps.knn_batch(X, Q, 5, device=CPU), ps.knn_tiled(
        X, Q, 5, tile_rows=100, device=CPU)
    assert got == want
    assert (_settings(), _legacy()) == set_


@pytest.mark.parametrize("m", [1, 3, 16])
def test_windows_match_jax(m):
    rng = np.random.default_rng(5 + m)
    x = np.cumsum(rng.normal(0, 1, 400))
    q = x[50:50 + m] + rng.normal(0, 0.1, m)
    np.testing.assert_array_equal(pw.window_sums(x, m), jw.window_sums(x, m))
    np.testing.assert_array_equal(pw.window_means(x, m), jw.window_means(x, m))
    for fn in ("window_dot", "window_l2", "window_corr"):
        np.testing.assert_array_equal(getattr(pw, fn)(x, q),
                                      getattr(jw, fn)(x, q), err_msg=fn)
    for metric in ("l2", "corr", "dot"):
        for a, b in zip(pw.knn_windows(x, q, 4, metric),
                        jw.knn_windows(x, q, 4, metric)):
            np.testing.assert_array_equal(a, b, err_msg=metric)
    with pytest.raises(ValueError):
        pw.knn_windows(x, q, 1, "cosine")


def test_online_mean_matches_jax():
    a, b = pw.OnlineMean(), jw.OnlineMean()
    assert a.mean == b.mean == 0.0
    for v in (3.0, -1.5, 8.25, 0.1):
        a.insert(v)
        b.insert(v)
        assert a.mean == b.mean
    a.remove(3.0)
    b.remove(3.0)
    assert a.mean == b.mean
