"""Query pushdown's reduce kernel: decoded values -> one word a column.

The JAX package reduces its decoded rows in XLA (``jnp.sum`` / ``max`` /
``min`` in ``sprintz_tpu/query/pushdown.py``'s fused and compact passes);
here one CUDA kernel (``csrc/query.cu``, ``reduce_cols_kernel``) reads the
narrow values once and leaves a (D,) int32 result on the device, so only D
words cross to the host. Sums are int32 and wrap mod 2^32, as the JAX
package's and the reference's i32 accumulators do (``torch.sum`` promises
no wrap, and with ``dtype=torch.int64`` would not wrap at all).

``reduce_cols`` launches the kernel for a CUDA tensor and runs
``reduce_cols_plain`` (int64 arithmetic masked to 32 bits) for a CPU
tensor; the plain version is what the CPU tests run and what the kernel is
held to on the card. ``reduce_cols.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import BLOCK_SZ
from . import _build
from .decode_kernels import check_args, to_device, widen

OPS = ("sum", "max", "min")  # the kernel's op codes 0, 1, 2
MIN_EMPTY = -1  # min over no rows: the kernel's start value 0xFFFFFFFF


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 of the same bits."""
    return (x - ((x & 0x80000000) << 1)).to(torch.int32)


def _gaps(gap_after, vals: torch.Tensor) -> torch.Tensor:
    """gap_after as a (rows / 8,) int32 tensor on the values' device."""
    rows = vals.shape[0]
    if rows % BLOCK_SZ:
        raise ValueError(f"reduce_cols: gap_after needs whole blocks of "
                         f"{BLOCK_SZ} rows, got {rows} rows")
    if torch.is_tensor(gap_after):
        g = gap_after.to(vals.device, torch.int32).contiguous()
    elif vals.device.type == "cuda":
        g = to_device(np.ascontiguousarray(gap_after, dtype=np.int32),
                      vals.device)
    else:
        g = torch.from_numpy(np.array(gap_after, dtype=np.int32))
    if tuple(g.shape) != (rows // BLOCK_SZ,):
        raise ValueError(f"reduce_cols: gap_after {tuple(g.shape)} is not "
                         f"({rows // BLOCK_SZ},)")
    return g


def _empty(op: str, ndims: int, leading_gap: bool,
           device: torch.device) -> torch.Tensor:
    """The result over no rows: 0, or min's start value."""
    fill = MIN_EMPTY if op == "min" and not leading_gap else 0
    return torch.full((ndims,), fill, dtype=torch.int32, device=device)


def reduce_cols_plain(vals: torch.Tensor, op: str, gap_after=None,
                      leading_gap: bool = False) -> torch.Tensor:
    """Plain version of ``reduce_cols``."""
    rows, ndims = vals.shape
    if rows == 0:
        return _empty(op, ndims, leading_gap, vals.device)
    v = widen(vals).to(torch.int64)
    if op == "sum":
        if gap_after is not None:
            w = torch.ones(rows, dtype=torch.int64, device=vals.device)
            w[BLOCK_SZ - 1::BLOCK_SZ] += _gaps(gap_after, vals).to(torch.int64)
            v = (v * w[:, None]) & 0xFFFFFFFF
        return _as_int32(v.sum(dim=0) & 0xFFFFFFFF)
    if op == "max":
        return v.amax(dim=0).to(torch.int32)
    m = v.amin(dim=0).to(torch.int32)
    return torch.clamp(m, max=0) if leading_gap else m


def reduce_cols(vals: torch.Tensor, op: str, gap_after=None,
                leading_gap: bool = False) -> torch.Tensor:
    """vals (rows, D) u8/u16, as ``decode_device`` returns them -> (D,)
    int32: each column's sum mod 2^32 (``op`` "sum"), max or min.

    ``gap_after``: None, or (rows / 8,) int32 (numpy or torch), the run rows
    that follow each 8-row block (the compact delta pass: a delta run
    repeats the value before it), so the last row of block b counts
    ``1 + gap_after[b]`` times in the sum; max and min ignore it.
    ``leading_gap``: the rows follow a run of zeros, which brings a 0 to
    min. Min over no rows is -1 (0xFFFFFFFF), 0 with a leading gap."""
    if op not in OPS:
        raise ValueError(f"reduce_cols: op must be one of {OPS}, got {op!r}")
    if vals.dtype not in (torch.uint8, torch.uint16) or vals.dim() != 2:
        raise TypeError(f"reduce_cols: vals must be (rows, D) uint8 or "
                        f"uint16, got {tuple(vals.shape)} {vals.dtype}")
    check_args("reduce_cols", vals.device, vals=(vals, vals.dtype))
    if gap_after is not None and op != "sum":
        gap_after = None  # runs repeat values that max and min already saw
    if vals.device.type == "cpu":
        return reduce_cols_plain(vals, op, gap_after, leading_gap)
    rows, ndims = vals.shape
    gaps = None if gap_after is None else _gaps(gap_after, vals)
    if rows == 0 or ndims == 0:
        return _empty(op, ndims, leading_gap, vals.device)
    out = torch.empty(ndims, dtype=torch.int32, device=vals.device)
    _build.launch("sprintz_reduce_cols", vals, vals.data_ptr(),
                  None if gaps is None else gaps.data_ptr(), out.data_ptr(),
                  rows, ndims, 8 * vals.element_size(), OPS.index(op),
                  int(leading_gap))
    reduce_cols.launches += 1
    return out


reduce_cols.launches = 0
