"""Query pushdown: max/sum/min reductions over a compressed stream.

Counterpart of ``sprintz_tpu/query/pushdown.py``: the reference's
``QueryParams{op, materialize}`` (query.hpp:22-29) and
``query_rowmajor_{delta,xff}_rle_{8,16}b``. The stream is walked and
gathered on the host, decoded on the card by ``decoder.decode_device``, and
reduced there: a delta stream's by the decode itself
(``ops/query_kernels.decode_reduce``: the reduce as the epilogue of K2 or
of the lowdim decode), a FIRE stream's by ``ops/query_kernels.reduce_cols``
(``csrc/query.cu``) after ``decoder.decode_device``. With
``materialize=False`` only the (D,) result leaves the card.

Two device passes, chosen as the JAX package chooses them (``last_path``
names the one the last call took: "verbatim", "compact" or "fused"):

- compact (delta, ``materialize=False``, an op other than NOOP): only the
  data blocks decode, as one contiguous timeline; run rows never
  materialise. A delta run holds the value before it (0 at the stream's
  start), and runs carry zero delta, so the prefix over the data rows
  alone is the timeline's at those rows. Each block's following run
  counts its last row again, ``gap_after`` times, in the sum; a leading
  run brings a 0 to min. Work is O(data blocks), not O(rows). The values
  never leave the chip (the epilogue's ``store=False``); the payload,
  widths and gaps go up in one copy.
- fused (xff, whose runs extrapolate row by row, or ``materialize=True``):
  the whole timeline (``decoder.place_blocks``), delta with the reduce as
  its decode's epilogue (``store=True``), xff decoded by
  ``decode_device``, then ``reduce_cols``.

Sums are int32 on the card and wrap mod 2^32, as the reference's i32
accumulators (query.hpp:283-291) and the JAX package's do; the host widens
them to int64 and adds the verbatim tail's int64 sums.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from ..constants import (BLOCK_SZ, LOWDIM_MAX_NDIMS, METADATA_LEN_RLE,
                         MIN_DATA_SIZE)
from ..decoder import (
    decode_device,
    download_values,
    gather_payloads,
    place_blocks,
    upload_payload,
    walk_headers,
)
from ..device import resolve_device
from ..errors import CorruptStreamError
from ..ops.decode_kernels import to_device_together
from ..ops.query_kernels import decode_reduce, reduce_cols
from ..stream_format import read_metadata_rle


class Operation(enum.Enum):
    NOOP = 0
    REDUCE_MAX = 1
    REDUCE_SUM = 2
    REDUCE_MIN = 3  # extension: not in the reference enum


_KERNEL_OP = {Operation.REDUCE_MAX: "max", Operation.REDUCE_SUM: "sum",
              Operation.REDUCE_MIN: "min"}


@dataclasses.dataclass(frozen=True)
class QueryParams:
    op: Operation = Operation.NOOP
    materialize: bool = True


@dataclasses.dataclass
class QueryResult:
    data: np.ndarray | None  # (rows, D) when materialized
    max: np.ndarray | None = None  # (D,)
    sum: np.ndarray | None = None  # (D,) int64
    min: np.ndarray | None = None  # (D,)


# diagnostic: which path the last query() call took
# ("compact" | "fused" | "verbatim")
last_path: str | None = None


def query(buf: bytes, params: QueryParams, codec: str = "delta",
          elem_sz: int = 1,
          device: str | torch.device | None = None) -> QueryResult:
    """Evaluate a query over a compressed stream; the decoded data reaches
    the host only with ``params.materialize``.

    ``device``: where the decode and the reduce run, CUDA by default
    (raises when CUDA is absent); ``"cpu"`` runs the kernels' plain
    versions (tests). Raises ``CorruptStreamError`` for a truncated or
    inconsistent stream."""
    global last_path
    if codec not in ("delta", "xff"):
        raise ValueError(f"codec must be 'delta' or 'xff', got {codec!r}")
    if elem_sz not in (1, 2):
        raise ValueError(f"elem_sz must be 1 or 2, got {elem_sz}")
    dev = resolve_device(device)
    udt = np.uint8 if elem_sz == 1 else np.uint16
    if len(buf) < METADATA_LEN_RLE:
        raise CorruptStreamError(
            f"stream shorter than its {METADATA_LEN_RLE}-byte metadata "
            f"({len(buf)} bytes)")
    ngroups, remaining_len, ndims = read_metadata_rle(buf)

    if ngroups == 0 and remaining_len < MIN_DATA_SIZE:
        last_path = "verbatim"
        if len(buf) < METADATA_LEN_RLE + remaining_len * elem_sz:
            raise CorruptStreamError("verbatim stream truncated")
        body = np.frombuffer(buf, dtype=udt, count=remaining_len,
                             offset=METADATA_LEN_RLE)
        rows = body.reshape(-1, ndims) if ndims else body.reshape(-1, 1)
        return _finish(rows, rows.shape[0], params)
    if ndims == 0:
        raise CorruptStreamError("metadata declares 0 dims")

    lowdim = ndims <= LOWDIM_MAX_NDIMS[elem_sz]
    idx = walk_headers(buf, ngroups, ndims, elem_sz, lowdim)
    if idx.tail_offset + remaining_len * elem_sz > len(buf):
        raise CorruptStreamError(
            f"verbatim tail truncated: need "
            f"{idx.tail_offset + remaining_len * elem_sz} bytes, "
            f"have {len(buf)}")
    ndata = idx.widths.shape[0]
    op = _KERNEL_OP.get(params.op)
    compact = codec == "delta" and not params.materialize and op is not None
    vals = red = None
    if compact:
        last_path = "compact"
        if ndata:  # else a pure-run stream: every row is 0
            gap_after = (np.diff(idx.out_rows, append=idx.total_rows)
                         - BLOCK_SZ).astype(np.int32)
            up = [gather_payloads(buf, idx), idx.widths, gap_after]
            dense, widths, gaps = (
                to_device_together(up, dev) if dev.type == "cuda"
                else [torch.from_numpy(a) for a in up])
            # the data blocks alone, as one run-free timeline, reduced as
            # they are decoded
            _, red = decode_reduce(dense, widths, 8 * elem_sz, op, gaps,
                                   bool(idx.out_rows[0] > 0), store=False,
                                   lowdim=lowdim)
    else:
        last_path = "fused"
        if idx.total_rows:
            up = upload_payload(gather_payloads(buf, idx), idx, dev)
            if codec == "delta" and op is not None:
                vals, red = decode_reduce(
                    *place_blocks(*up, idx.total_rows), 8 * elem_sz, op,
                    lowdim=lowdim)
            else:
                vals = decode_device(*up, idx.total_rows, elem_sz, codec,
                                     lowdim)
                if op is not None:
                    red = reduce_cols(vals, op)

    tail = np.frombuffer(buf, dtype=udt, count=remaining_len,
                         offset=idx.tail_offset)
    tail_rows = tail[: (remaining_len // ndims) * ndims].reshape(-1, ndims)

    res = QueryResult(data=None)
    if op is not None:
        dev_red = (np.zeros(ndims, np.int64) if red is None
                   else red.cpu().numpy().astype(np.int64))
        if params.op == Operation.REDUCE_MAX:
            if tail_rows.size:
                dev_red = np.maximum(dev_red, tail_rows.max(axis=0))
            res.max = dev_red.astype(udt)
        elif params.op == Operation.REDUCE_MIN:
            if idx.total_rows == 0:
                dev_red = np.full(ndims, np.iinfo(np.int64).max)
            if tail_rows.size:
                dev_red = np.minimum(dev_red, tail_rows.min(axis=0))
            res.min = dev_red.astype(udt)
        else:
            if tail_rows.size:
                dev_red = dev_red + tail_rows.sum(axis=0, dtype=np.int64)
            res.sum = dev_red
    if params.materialize:
        body = (np.zeros(0, udt) if vals is None else download_values(vals))
        res.data = np.concatenate([body, tail]).reshape(-1, ndims)
    return res


def _finish(rows: np.ndarray, nrows: int, params: QueryParams) -> QueryResult:
    """A verbatim stream's result, reduced on the host."""
    res = QueryResult(data=rows if params.materialize else None)
    if params.op == Operation.REDUCE_MAX:
        res.max = rows.max(axis=0) if nrows else None
    elif params.op == Operation.REDUCE_MIN:
        res.min = rows.min(axis=0) if nrows else None
    elif params.op == Operation.REDUCE_SUM:
        res.sum = rows.sum(axis=0, dtype=np.int64) if nrows else None
    return res
