"""Query pushdown's reduce kernels: decoded values -> one word a column.

The JAX package reduces its decoded rows in XLA (``jnp.sum`` / ``max`` /
``min`` in ``sprintz_tpu/query/pushdown.py``'s fused and compact passes).
Here the reduce leaves a (D,) int32 result on the device, so only D words
cross to the host, in one of three kernels:

- ``decode_reduce``: the delta decode with the reduce as its epilogue,
  for the compact and fused delta passes: K1 then K2's ``REDUCE``
  instantiation (``prefix_finish_reduce``), or the lowdim decode's
  (``decode_lowdim_reduce``), in ``csrc/decode.cu``. The kernel that
  finishes the values folds them as it writes them (``store``) or without
  writing them at all (the compact pass);
- ``reduce_cols`` (``csrc/query.cu``): values already on the card (the
  FIRE decode's, in the fused pass) read once.

Sums are int32 and wrap mod 2^32, as the JAX package's and the reference's
i32 accumulators do (``torch.sum`` promises no wrap, and with
``dtype=torch.int64`` would not wrap at all). Across CTAs the kernels add
into kept accumulators (``reduce_scratch``: D words and a count, one
buffer a device and stream, zero between launches: each launch's last CTA
writes the result and clears them), so no launch needs a memset.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version (``*_plain``: the plain decode, then ``reduce_cols_plain``, int64
arithmetic masked to 32 bits) for a CPU tensor; the plain versions are what
the CPU tests run and what the kernels are held to on the card. Their
``launches`` attributes count the kernels' launches. No wrapper reads from
the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import BLOCK_SZ
from . import _build
from . import decode_kernels as dk
from .decode_kernels import check_args, to_device, widen

OPS = ("sum", "max", "min")  # the kernels' op codes 0, 1, 2
MIN_EMPTY = -1  # min over no rows: 0xFFFFFFFF


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 of the same bits."""
    return (x - ((x & 0x80000000) << 1)).to(torch.int32)


def _check_op(name: str, op: str) -> None:
    if op not in OPS:
        raise ValueError(f"{name}: op must be one of {OPS}, got {op!r}")


def _gaps(gap_after, rows: int, device: torch.device,
          name: str = "reduce_cols") -> torch.Tensor:
    """gap_after as a (rows / 8,) int32 tensor on ``device``, 16-byte
    aligned (a numpy array goes up in a pinned copy of its own)."""
    if rows % BLOCK_SZ:
        raise ValueError(f"{name}: gap_after needs whole blocks of "
                         f"{BLOCK_SZ} rows, got {rows} rows")
    if torch.is_tensor(gap_after):
        g = gap_after.to(device, torch.int32).contiguous()
    elif device.type == "cuda":
        g = to_device(np.ascontiguousarray(gap_after, dtype=np.int32), device)
    else:
        g = torch.from_numpy(np.array(gap_after, dtype=np.int32))
    if tuple(g.shape) != (rows // BLOCK_SZ,):
        raise ValueError(f"{name}: gap_after {tuple(g.shape)} is not "
                         f"({rows // BLOCK_SZ},)")
    return dk.aligned16(g)


def _empty(op: str, ndims: int, leading_gap: bool,
           device: torch.device) -> torch.Tensor:
    """The result over no rows: 0, or min's start value."""
    fill = MIN_EMPTY if op == "min" and not leading_gap else 0
    return torch.full((ndims,), fill, dtype=torch.int32, device=device)


# The kept accumulators, one buffer a (device, stream): every launch leaves
# them zeroed (its last CTA clears them), so only a new or grown buffer
# costs a fill.
_reduce_acc: dict[tuple[int, int], torch.Tensor] = {}


def reduce_scratch(device: torch.device, ndims: int) -> torch.Tensor:
    """At least ``ndims + 1`` zeroed int32 words (D accumulators and a
    count) for a reduce on ``device``'s current stream."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _reduce_acc.get(key)
    if buf is None or buf.numel() < ndims + 1:
        buf = _reduce_acc[key] = torch.zeros(ndims + 1, dtype=torch.int32,
                                             device=device)
    return buf


# ------------------------------------------------------------ reduce_cols


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
            w[BLOCK_SZ - 1::BLOCK_SZ] += _gaps(gap_after, rows,
                                               vals.device).to(torch.int64)
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
    _check_op("reduce_cols", op)
    if vals.dtype not in (torch.uint8, torch.uint16) or vals.dim() != 2:
        raise TypeError(f"reduce_cols: vals must be (rows, D) uint8 or "
                        f"uint16, got {tuple(vals.shape)} {vals.dtype}")
    check_args("reduce_cols", vals.device, vals=(vals, vals.dtype))
    if gap_after is not None and op != "sum":
        gap_after = None  # runs repeat values that max and min already saw
    if vals.device.type == "cpu":
        return reduce_cols_plain(vals, op, gap_after, leading_gap)
    rows, ndims = vals.shape
    gaps = None if gap_after is None else _gaps(gap_after, rows, vals.device)
    if rows == 0 or ndims == 0:
        return _empty(op, ndims, leading_gap, vals.device)
    vals = dk.aligned16(vals)
    out = torch.empty(ndims, dtype=torch.int32, device=vals.device)
    _build.launch("sprintz_reduce_cols", vals, vals.data_ptr(),
                  None if gaps is None else gaps.data_ptr(), out.data_ptr(),
                  rows, ndims, 8 * vals.element_size(), OPS.index(op),
                  int(leading_gap),
                  reduce_scratch(vals.device, ndims).data_ptr())
    reduce_cols.launches += 1
    return out


reduce_cols.launches = 0


# ------------------------------------------------ the decode's epilogue


def prefix_finish_reduce_plain(bz: torch.Tensor, tile_offsets: torch.Tensor,
                               elem_bits: int, op: str, gap_after=None,
                               leading_gap: bool = False, store: bool = True):
    """Plain version of ``prefix_finish_reduce``: K2's plain version, then
    ``reduce_cols_plain``."""
    vals = dk.prefix_finish_plain(bz, tile_offsets, elem_bits)
    red = reduce_cols_plain(vals, op, gap_after if op == "sum" else None,
                            leading_gap)
    return (vals if store else None), red


def _epilogue_args(name: str, op: str, gap_after, rows: int,
                   device: torch.device):
    """The op's code and the gaps on ``device`` (None but for a sum)."""
    _check_op(name, op)
    if gap_after is None or op != "sum":
        return OPS.index(op), None
    return OPS.index(op), _gaps(gap_after, rows, device, name)


def prefix_finish_reduce(bz: torch.Tensor, tile_offsets: torch.Tensor,
                         elem_bits: int, op: str, gap_after=None,
                         leading_gap: bool = False, store: bool = True):
    """K2 with the reduce as its epilogue: ``dk.prefix_finish``'s inputs
    (bz (rows, D) biased deltas, the tiles' offsets) -> (values (rows, D)
    or None without ``store``, (D,) int32 as ``reduce_cols(values, op,
    gap_after, leading_gap)``), in one launch. Serial decode only."""
    odt = dk.narrow_dtype(elem_bits)
    check_args("prefix_finish_reduce", bz.device, bz=(bz, odt),
               tile_offsets=(tile_offsets, torch.int32))
    rows, ndims = bz.shape
    ntiles = -(-rows // dk.TILE_ROWS)
    if tuple(tile_offsets.shape) != (ntiles, 1, ndims):
        raise ValueError(f"prefix_finish_reduce: tile_offsets "
                         f"{tuple(tile_offsets.shape)} != {(ntiles, 1, ndims)}")
    code, gaps = _epilogue_args("prefix_finish_reduce", op, gap_after, rows,
                                bz.device)
    if bz.device.type == "cpu":
        return prefix_finish_reduce_plain(bz, tile_offsets, elem_bits, op,
                                          gaps, leading_gap, store)
    out = torch.empty_like(bz) if store else None
    if rows == 0 or ndims == 0:
        return out, _empty(op, ndims, leading_gap, bz.device)
    bz, tile_offsets = dk.aligned16(bz), dk.aligned16(tile_offsets)
    red = torch.empty(ndims, dtype=torch.int32, device=bz.device)
    _build.launch("sprintz_prefix_finish_reduce", bz, bz.data_ptr(),
                  tile_offsets.data_ptr(),
                  None if out is None else out.data_ptr(), rows, ndims,
                  elem_bits, code, None if gaps is None else gaps.data_ptr(),
                  int(leading_gap), int(store),
                  reduce_scratch(bz.device, ndims).data_ptr(), red.data_ptr())
    prefix_finish_reduce.launches += 1
    return out, red


prefix_finish_reduce.launches = 0


def decode_lowdim_reduce_plain(dense: torch.Tensor, widths: torch.Tensor,
                               elem_bits: int, op: str, gap_after=None,
                               leading_gap: bool = False, store: bool = True):
    """Plain version of ``decode_lowdim_reduce``: the lowdim decode's plain
    version, then ``reduce_cols_plain``."""
    vals = dk.decode_delta_lowdim_plain(dense, widths, elem_bits)
    red = reduce_cols_plain(vals, op, gap_after if op == "sum" else None,
                            leading_gap)
    return (vals if store else None), red


def decode_lowdim_reduce(dense: torch.Tensor, widths: torch.Tensor,
                         elem_bits: int, op: str, gap_after=None,
                         leading_gap: bool = False, store: bool = True):
    """The lowdim delta decode with the reduce as its epilogue:
    ``dk.decode_delta_lowdim``'s inputs -> (values (nb * 8, D) or None
    without ``store``, (D,) int32), in one launch. Serial decode only."""
    if dk.check_lowdim_payload("decode_lowdim_reduce", dense,
                               widths) != elem_bits:
        raise ValueError(f"decode_lowdim_reduce: sections of "
                         f"{dense.shape[2]} bytes are not those of elem_bits "
                         f"{elem_bits}")
    nb, ndims, _ = dense.shape
    code, gaps = _epilogue_args("decode_lowdim_reduce", op, gap_after,
                                nb * BLOCK_SZ, dense.device)
    if dense.device.type == "cpu":
        return decode_lowdim_reduce_plain(dense, widths, elem_bits, op, gaps,
                                          leading_gap, store)
    out = (torch.empty((nb * BLOCK_SZ, ndims), dtype=dk.narrow_dtype(elem_bits),
                       device=dense.device) if store else None)
    if nb == 0:
        return out, _empty(op, ndims, leading_gap, dense.device)
    dense, widths = dk.aligned16(dense), dk.aligned16(widths)
    nspans = -(-nb // dk.lowdim_span_blocks(elem_bits, ndims))
    red = torch.empty(ndims, dtype=torch.int32, device=dense.device)
    _build.launch("sprintz_decode_lowdim_reduce", dense, dense.data_ptr(),
                  widths.data_ptr(), None if out is None else out.data_ptr(),
                  dk.lowdim_status(dense.device, nspans + 1).data_ptr(), nb,
                  ndims, elem_bits, code,
                  None if gaps is None else gaps.data_ptr(), int(leading_gap),
                  int(store), reduce_scratch(dense.device, ndims).data_ptr(),
                  red.data_ptr())
    decode_lowdim_reduce.launches += 1
    return out, red


decode_lowdim_reduce.launches = 0


def decode_reduce_plain(dense: torch.Tensor, widths: torch.Tensor,
                        elem_bits: int, op: str, gap_after=None,
                        leading_gap: bool = False, store: bool = True,
                        lowdim: bool = False):
    """Plain version of ``decode_reduce``: the plain decode
    (``decode_delta_contiguous``'s two plain kernels, or the lowdim
    decode's), then ``reduce_cols_plain``."""
    if lowdim:
        return decode_lowdim_reduce_plain(dense, widths, elem_bits, op,
                                          gap_after, leading_gap, store)
    bz, toff = dk.unpack_zz_plain(dense, widths, elem_bits)
    return prefix_finish_reduce_plain(bz.reshape(-1, widths.shape[1]), toff,
                                      elem_bits, op, gap_after, leading_gap,
                                      store)


def decode_reduce(dense: torch.Tensor, widths: torch.Tensor, elem_bits: int,
                  op: str, gap_after=None, leading_gap: bool = False,
                  store: bool = True, lowdim: bool = False):
    """Run-free delta decode with the reduce as its epilogue: the payload
    (``dk.decode_delta_contiguous``'s dense (nb, 8, MAXB) and widths, or
    with ``lowdim`` ``dk.decode_delta_lowdim``'s sections) -> (values
    (nb * 8, D) u8/u16, or None without ``store``, (D,) int32 as
    ``reduce_cols(values, op, gap_after, leading_gap)``).

    Row-major: K1 (``dk.unpack_zz``), then ``prefix_finish_reduce``; lowdim:
    ``decode_lowdim_reduce``, one launch. No standalone reduce and no
    memset."""
    if lowdim:
        return decode_lowdim_reduce(dense, widths, elem_bits, op, gap_after,
                                    leading_gap, store)
    _check_op("decode_reduce", op)
    if dense.device.type == "cpu":
        return decode_reduce_plain(dense, widths, elem_bits, op, gap_after,
                                   leading_gap, store)
    bz, toff = dk.unpack_zz(dense, widths, elem_bits)
    return prefix_finish_reduce(bz.reshape(-1, widths.shape[1]), toff,
                                elem_bits, op, gap_after, leading_gap, store)
