"""Brute-force similarity search over row matrices, on the card.

Counterpart of ``sprintz_tpu/search.py``, with its answers: the
reference's nn_search layer (nn_search.hpp:69-385: radius / onenn / knn
single-query and *_batch variants over row matrices, with optional
precomputed row squared norms; nn_utils.hpp:33 Neighbor), an unbuildable
vestige there (nn_search.hpp:13 includes a missing euclidean.hpp).

- All distances come from ONE float32 ``torch.matmul``:
  ||x||^2 - 2 X Q^T + ||q||^2, batched over queries, clamped at 0, in the
  JAX package's order of operations. The product runs at full float32
  precision whatever the caller set (``device.exact_fp32_matmul``; the
  JAX package's ``Precision.HIGHEST``), so integer-valued data up to 2^24
  gives exact distances.
- Top-k in ``jax.lax.top_k``'s order: ascending distance, the lower index
  first among equal distances. ``torch.topk`` promises no order among
  ties, so the k smallest are taken of a unique int64 key a candidate: the
  distance's float32 bits (non-negative, so ordered as the floats) above
  its position.
- ``knn_tiled`` streams X through a Python loop over row tiles on the
  device, carrying the running (Q, k) best, so peak memory is
  O(tile_rows * (D + nqueries)) instead of the (N, Q) matrix; the running
  best sits before the tile in each merge, as in the JAX scan. Early
  abandoning (nn_search.hpp namespace abandon) is a scalar-CPU
  optimization; the tiled scan is its memory-bounded equivalent.
- Radius queries return a fixed-shape boolean mask and the distances from
  the device; ``neighbors_in_radius`` makes the reference's
  variable-length Neighbor lists on the host.

Inputs are numpy arrays or tensors; every entry point takes ``device``
(CUDA by default, raising without it; ``"cpu"`` for tests).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import exact_fp32_matmul, resolve_device


class Neighbor(NamedTuple):
    """Index + squared-L2 distance (nn_utils.hpp:33)."""

    idx: int
    dist: float


def _f32(a, dev: torch.device) -> torch.Tensor:
    """numpy array or tensor -> float32 tensor on ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.to(dev, torch.float32)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)


def _queries(Q, dev: torch.device) -> torch.Tensor:
    return torch.atleast_2d(_f32(Q, dev))


def row_norms_sq(X, device=None) -> torch.Tensor:
    """Precomputed per-row squared norms (the rowSquaredNorms operand
    of nn_search.hpp's brute:: overloads), on the device. Reusable across
    queries."""
    X = _f32(X, resolve_device(device))
    return (X * X).sum(dim=-1)


def _dists(X: torch.Tensor, Q: torch.Tensor, xn: torch.Tensor,
           qn: torch.Tensor, by_query: bool = False) -> torch.Tensor:
    """(N, Q) squared distances, or (Q, N) with ``by_query``: xn - 2 X.Q
    + qn, each step rounded as the JAX package rounds it (-2 * cross is
    exact, and added to xn it is xn - 2 * cross)."""
    with exact_fp32_matmul():
        cross = torch.matmul(Q, X.T) if by_query else torch.matmul(X, Q.T)
    if by_query:
        xn, qn = xn[None, :], qn[:, None]
    else:
        xn, qn = xn[:, None], qn[None, :]
    return cross.mul_(-2.0).add_(xn).add_(qn).clamp_min_(0.0)


def squared_dists(X, Q, x_norms=None, device=None) -> torch.Tensor:
    """(N, D) x (Q, D) -> (N, Q) squared L2 distances in one matmul
    (dist::squared_dists_to_vectors in the reference's Eigen layer)."""
    dev = resolve_device(device)
    X, Q = _f32(X, dev), _queries(Q, dev)
    xn = (X * X).sum(dim=-1) if x_norms is None else _f32(x_norms, dev)
    return _dists(X, Q, xn, (Q * Q).sum(dim=-1))


def _smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row of d (R, C) float32 >= 0 -> (values,
    positions) (R, k), ascending, the lower position first among equal
    values (``lax.top_k``'s order on -d). The sign bit is cleared, so a
    -0.0 ranks as 0.0."""
    key = d.view(torch.int32).to(torch.int64).bitwise_and_(0x7FFFFFFF)
    key.bitwise_left_shift_(32).bitwise_or_(
        torch.arange(d.shape[1], device=d.device))
    top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    vals = (top >> 32).to(torch.int32).view(torch.float32)
    return vals, top & 0xFFFFFFFF


def _neighbor_lists(idxs: torch.Tensor, dists: torch.Tensor,
                    n: int | None = None) -> list[list[Neighbor]]:
    """(Q, k) indices and distances -> one Neighbor list a query; with
    ``n``, rows at or past it (padding) are dropped."""
    idxs, dists = idxs.cpu().numpy(), dists.cpu().numpy()
    return [[Neighbor(int(i), float(d)) for i, d in zip(qi, qd)
             if n is None or i < n]
            for qi, qd in zip(idxs, dists)]


def knn_batch(X, Q, k: int, x_norms=None,
              device=None) -> list[list[Neighbor]]:
    """k nearest rows of X for every query row (brute::knn_batch,
    nn_search.hpp:224-239). Returns one ascending-distance Neighbor
    list per query."""
    dev = resolve_device(device)
    X, Q = _f32(X, dev), _queries(Q, dev)
    k_eff = min(int(k), X.shape[0])
    if k_eff <= 0:
        return [[] for _ in range(Q.shape[0])]
    xn = (X * X).sum(dim=-1) if x_norms is None else _f32(x_norms, dev)
    d = _dists(X, Q, xn, (Q * Q).sum(dim=-1), by_query=True)
    dists, idxs = _smallest(d, k_eff)
    return _neighbor_lists(idxs, dists)


def knn(X, q, k: int, x_norms=None, device=None) -> list[Neighbor]:
    """Single-query knn (brute::knn, nn_search.hpp:185-195)."""
    return knn_batch(X, q, k, x_norms, device)[0]


def onenn_batch(X, Q, x_norms=None, device=None) -> list[Neighbor]:
    """Nearest row per query (brute::onenn_batch)."""
    return [nb[0] for nb in knn_batch(X, Q, 1, x_norms, device)]


def onenn(X, q, x_norms=None, device=None) -> Neighbor:
    """Single-query 1-NN (brute::onenn, nn_search.hpp:148-163)."""
    return onenn_batch(X, q, x_norms, device)[0]


def radius_mask(X, Q, radius_sq: float, x_norms=None, device=None):
    """Fixed-shape radius query: (N, Q) bool mask of rows with
    d^2 < radius_sq (compared in float32), plus the distances, on the
    device (the device-side half of brute::radius_batch)."""
    d = squared_dists(X, Q, x_norms, device)
    return d < radius_sq, d


def neighbors_in_radius(dists, mask=None,
                        radius_sq: float | None = None
                        ) -> list[list[Neighbor]]:
    """Host conversion of a distance column set to variable-length
    Neighbor lists (nn_utils.hpp neighbors_in_radius), ascending."""
    dists = np.atleast_2d(np.asarray(dists))
    if mask is None:
        mask = dists < radius_sq
    mask = np.atleast_2d(np.asarray(mask))
    out = []
    for j in range(dists.shape[1]):
        rows = np.nonzero(mask[:, j])[0]
        order = rows[np.argsort(dists[rows, j], kind="stable")]
        out.append([Neighbor(int(i), float(dists[i, j])) for i in order])
    return out


def radius_batch(X, Q, radius_sq: float, x_norms=None,
                 device=None) -> list[list[Neighbor]]:
    """All rows within radius for every query (brute::radius_batch,
    nn_search.hpp:208-222)."""
    mask, d = radius_mask(X, Q, radius_sq, x_norms, device)
    return neighbors_in_radius(d.cpu().numpy(), mask.cpu().numpy())


def radius(X, q, radius_sq: float, x_norms=None,
           device=None) -> list[Neighbor]:
    """Single-query radius search (brute::radius / simple::radius)."""
    return radius_batch(X, q, radius_sq, x_norms, device)[0]


def knn_tiled(X, Q, k: int, tile_rows: int = 16384,
              device=None) -> list[list[Neighbor]]:
    """knn_batch over huge X without materializing the (N, Q) distance
    matrix: row tiles of X stream through a loop on the device, carrying
    the running top-k. X is padded to a multiple of ``tile_rows`` with
    sentinel rows (at ~2e18 squared distance: they never beat a real row),
    which the result drops."""
    dev = resolve_device(device)
    X, Q = _f32(X, dev), _queries(Q, dev)
    X = torch.atleast_2d(X)
    n = X.shape[0]
    k_eff = min(int(k), n)
    if k_eff <= 0:
        return [[] for _ in range(Q.shape[0])]
    tile_rows = max(min(tile_rows, n), 1)
    npad = -n % tile_rows
    if npad:
        X = torch.cat([X, X.new_full((npad, X.shape[1]), 1.5e9)])
    nq = Q.shape[0]
    qn = (Q * Q).sum(dim=-1)
    best_d = torch.full((nq, k_eff), float("inf"), device=dev)
    best_i = torch.full((nq, k_eff), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(tile_rows, device=dev)
    for start in range(0, X.shape[0], tile_rows):
        tile = X[start:start + tile_rows]
        d = _dists(tile, Q, (tile * tile).sum(dim=-1), qn, by_query=True)
        cat_i = torch.cat([best_i, (rows + start).expand(nq, -1)], dim=1)
        best_d, pos = _smallest(torch.cat([best_d, d], dim=1), k_eff)
        best_i = torch.gather(cat_i, 1, pos)
    return _neighbor_lists(best_i, best_d, n)
