"""Learned filter banks: greedy brute-force forecaster search, on the card.

Counterpart of ``sprintz_tpu/models/learning.py``: the reference's
research tooling for choosing FIRE-style forecaster filter banks
(python/learning.py:253-398 ``greedy_brute_filters`` + helpers :94-196)
as streamed matrix products:

- every candidate filter (all (2^nbits)^ntaps quantized tap vectors) is
  scored in one float32 (chunk, ntaps) @ (ntaps, N) ``torch.matmul`` per
  candidate chunk, at full float32 precision whatever the caller set
  (``device.exact_fp32_matmul``); a candidate's errors are a row, so the
  scans and reductions below run along the innermost dim (a
  ``torch.cumsum`` down dim 0 of the JAX package's (N, chunk) layout runs
  a column a thread, several times slower on the card);
- per-block losses (length-``block_sz`` sliding windows, stride 1 — a
  filter must predict whole blocks, like the real codec) reduce via a
  ``torch.cumsum`` difference (l2, l1) or a log-step sliding max (linf)
  instead of materializing (C, N, B) windows;
- the greedy rounds keep only the running best per-position loss (N',)
  on the device; candidate chunks stream through, so peak memory is
  O(N * chunk) rather than O(N * C). A round's means come to the host in
  one copy, where ``np.argmin`` picks the first of equal minima.

Semantics match the reference and the JAX package: same candidate grid
(values centered at +1 in steps of ``step_sz``), same greedy objective
mean_i min(best_loss_i, loss_i[c]), same l2/l1/linf losses. This is a
research utility (float math, not byte-exact coding): float32 sums round
differently from XLA's, so two candidates whose means differ by less than
their rounding may be picked the other way round (``candidate_means_plain``
recomputes a round's means in float64 to tell).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import exact_fp32_matmul, resolve_device

__all__ = ["all_possible_filters", "candidate_means_plain",
           "greedy_brute_filters", "greedy_search"]


def all_possible_filters(ntaps: int, nbits: int = 4, step_sz: float = 0.25
                         ) -> np.ndarray:
    """Every quantized filter: (2^nbits)^ntaps rows of ntaps taps.

    Tap values are ``(k + 1/step_sz - 2^(nbits-1)) * step_sz`` for
    k in [0, 2^nbits) — the reference's grid centered at +1
    (learning.py:94-106).
    """
    assert (1 << nbits) ** ntaps < 100 * 1000, "candidate grid too large"
    nvals = 1 << nbits
    vals = (np.arange(nvals, dtype=np.float32)
            + int(1.0 / step_sz) - (nvals >> 1)) * step_sz
    grids = np.meshgrid(*([vals] * ntaps), indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=1)


def _training_set(x, ntaps: int, max_samples: int):
    """The signal's head -> lagged inputs X (N, ntaps) and targets y (N,),
    float32: training positions capped at ``max_samples``."""
    x = np.asarray(x, dtype=np.float32).reshape(-1)[: max_samples + ntaps]
    X = np.stack([x[i : len(x) - ntaps + i] for i in range(ntaps)], axis=1)
    y = x[ntaps:].astype(np.float32)
    return X[: len(y)], y


def _block_reduce(losses: torch.Tensor, block_sz: int,
                  loss: str) -> torch.Tensor:
    """Per-sample -> per-sliding-block losses along the last dim (stride
    1, length block_sz; learning.py:167-173 windows_as_dim3). l2/l1 are
    per-sample summables, so the window sum is a cumsum difference; linf is
    a log-step sliding max."""
    if block_sz <= 1:
        return losses
    n = losses.shape[-1]
    if loss == "linf":
        out = losses
        shift = 1
        width = 1
        while width < block_sz:
            step = min(shift, block_sz - width)
            out = torch.maximum(out[..., : n - step],
                                out[..., step:][..., : n - step])
            n = out.shape[-1]
            width += step
            shift *= 2
        return out
    c = torch.cumsum(losses, dim=-1)
    return torch.cat([c[..., block_sz - 1 : block_sz],
                      c[..., block_sz:] - c[..., :-block_sz]], dim=-1)


def greedy_search(
    x: np.ndarray,
    nfilters: int = 4,
    ntaps: int = 4,
    nbits: int = 4,
    step_sz: float = 0.5,
    block_sz: int = -1,
    loss: str = "l2",
    chunk: int = 4096,
    max_samples: int = 1 << 16,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``greedy_brute_filters`` -> (filters (nfilters, ntaps) float32, the
    objective each round's pick reached on the device (nfilters,)
    float32, each round's seconds by the host's clock (nfilters,): a
    round ends when its means reach the host)."""
    assert loss in ("l2", "l1", "linf"), f"unsupported loss {loss!r}"
    dev = resolve_device(device)
    block_sz = max(1, block_sz)
    X, y = _training_set(x, ntaps, max_samples)
    cands = all_possible_filters(ntaps, nbits, step_sz)
    C = cands.shape[0]
    npad = (-C) % chunk
    cand_chunks = torch.from_numpy(
        np.pad(cands, ((0, npad), (0, 0))).reshape(-1, chunk, ntaps)).to(dev)
    Xd = torch.from_numpy(X).to(dev)
    yd = torch.from_numpy(y).to(dev)

    def block_losses(errs):
        per = errs * errs if loss == "l2" else errs.abs()
        return _block_reduce(per, block_sz, loss)

    filters = np.zeros((nfilters, ntaps), dtype=np.float32)
    objective = np.zeros(nfilters, dtype=np.float32)
    round_s = np.zeros(nfilters)
    with exact_fp32_matmul():
        # start from no filters: best loss = loss of predicting zero
        # (reference: errs = y when the filter list is empty, :108-112)
        best = block_losses(yd)
        for i in range(nfilters):
            t0 = time.perf_counter()
            means = torch.cat([
                torch.minimum(block_losses(yd - cc @ Xd.T), best).mean(dim=1)
                for cc in cand_chunks]).cpu().numpy()[:C]
            round_s[i] = time.perf_counter() - t0
            bidx = int(np.argmin(means))
            filters[i] = cands[bidx]
            objective[i] = means[bidx]
            best = torch.minimum(best, block_losses(
                yd - Xd @ torch.from_numpy(cands[bidx]).to(dev)))
    return filters, objective, round_s


def greedy_brute_filters(
    x: np.ndarray,
    nfilters: int = 4,
    ntaps: int = 4,
    nbits: int = 4,
    step_sz: float = 0.5,
    block_sz: int = -1,
    loss: str = "l2",
    chunk: int = 4096,
    max_samples: int = 1 << 16,
    device=None,
) -> np.ndarray:
    """Greedily pick ``nfilters`` filters minimizing the mean of the
    per-position best loss (reference learning.py:253-398, as streamed
    matrix products on the device).

    x: 1-D training signal. Returns (nfilters, ntaps) float32.
    ``chunk``: candidates per device pass (bounds the (N, chunk)
    intermediate). ``max_samples``: training positions are capped by
    subsampling the signal head (a research fit, like the reference's
    small UCR slices). ``device``: CUDA unless named (``"cpu"`` for tests).
    """
    return greedy_search(x, nfilters, ntaps, nbits, step_sz, block_sz, loss,
                         chunk, max_samples, device)[0]


def candidate_means_plain(x, chosen: np.ndarray, cands: np.ndarray,
                          ntaps: int, block_sz: int = -1, loss: str = "l2",
                          max_samples: int = 1 << 16) -> np.ndarray:
    """Plain float64 numpy version of one greedy round: the objective of
    each row of ``cands`` after the filters in ``chosen`` (k, ntaps) were
    picked, a candidate at a time (cheap for a few hundred)."""
    block_sz = max(1, block_sz)
    X, y = _training_set(x, ntaps, max_samples)
    X, y = X.astype(np.float64), y.astype(np.float64)

    def block_losses(errs):
        per = errs * errs if loss == "l2" else np.abs(errs)
        if block_sz <= 1:
            return per
        n = per.shape[0] - block_sz + 1
        if loss == "linf":
            return np.max([per[i : i + n] for i in range(block_sz)], axis=0)
        c = np.concatenate([[0.0], np.cumsum(per)])
        return c[block_sz:] - c[:n]

    best = block_losses(y)
    for f in np.asarray(chosen, np.float64).reshape(-1, ntaps):
        best = np.minimum(best, block_losses(y - X @ f))
    return np.array([np.minimum(block_losses(y - X @ c), best).mean()
                     for c in np.asarray(cands, np.float64)])
