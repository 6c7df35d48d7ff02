"""The query's reduce as the delta decode's epilogue
(``ops/query_kernels.decode_reduce``, whose CPU path is its plain version:
the plain decode, then ``reduce_cols_plain``) against the JAX package's
query pushdown (``sprintz_tpu.query.pushdown.query``) on the same bytes,
exactly (integers: the tolerance is zero): u8 and u16, row-major and
lowdim, the compact pass's data blocks with their gaps and the fused
pass's whole timeline, every op, with and without ``store``; streams with
leading, middle and trailing runs and a u16 stream whose sum wraps past
2^31 through a long run. Then a spy on the port's ``query``: delta goes
through ``decode_reduce`` and never ``reduce_cols``, xff through
``reduce_cols``, with the JAX package's ``last_path``. The JAX package's
passes compile once a shape and op, in a module-scoped fixture."""

import numpy as np
import pytest
import torch

from sprintz_tpu.query import pushdown as jq
from sprintz_tpu_torch import decoder as tdec
from sprintz_tpu_torch import encoder as tenc
from sprintz_tpu_torch.constants import BLOCK_SZ, LOWDIM_MAX_NDIMS
from sprintz_tpu_torch.ops import query_kernels as qk
from sprintz_tpu_torch.query import pushdown as tq
from sprintz_tpu_torch.stream_format import read_metadata_rle

OPS = {"sum": "REDUCE_SUM", "max": "REDUCE_MAX", "min": "REDUCE_MIN"}
CPU = torch.device("cpu")


def runs_stream(rng, es: int, ndims: int, nrows: int = 603) -> np.ndarray:
    """A walk with a leading run of zeros, a run in the middle, a run to the
    end of the blocks and a verbatim tail."""
    dt = np.uint8 if es == 1 else np.uint16
    x = (np.cumsum(rng.integers(-5, 6, (nrows, ndims)), axis=0)
         % (1 << (8 * es))).astype(dt)
    x[:40] = 0
    x[200:300] = x[199]
    x[-60:] = x[-61]
    return x


def wrap_stream(rng) -> np.ndarray:
    """u16 values near 65000 with a run of 35700 rows in the middle: the
    sum passes 2^31 through the run's gap (37003 rows of 5 dims)."""
    x = (65000 + rng.integers(0, 535, (37003, 5))).astype(np.uint16)
    x[300:36000] = x[299]
    return x


# row-major u8 and u16, lowdim u8 and u16 (runs streams), the u16 wrap
STREAMS = ["u8 D 9", "u16 D 5", "u8 D 3", "u16 D 2", "u16 wrap"]


def make_stream(name: str) -> tuple[int, np.ndarray]:
    rng = np.random.default_rng(STREAMS.index(name) + 40)
    if name == "u16 wrap":
        return 2, wrap_stream(rng)
    es = 1 if name.startswith("u8") else 2
    return es, runs_stream(rng, es, int(name.split()[-1]))


@pytest.fixture(scope="module")
def cases():
    """Each stream's elem_sz, rows, bytes and the JAX package's compact
    query results (materialize False) by op, and its fused path's on the
    first stream (the sum)."""
    out = {}
    for name in STREAMS:
        es, x = make_stream(name)
        buf = tenc.compress(x.reshape(-1), x.shape[1], device="cpu")
        res, paths = {}, {}
        for op, jop in OPS.items():
            res[op] = jq.query(buf, jq.QueryParams(jq.Operation[jop], False),
                               "delta", es)
            paths[op, False] = jq.last_path
        if name == STREAMS[0]:
            res["fused sum"] = jq.query(
                buf, jq.QueryParams(jq.Operation.REDUCE_SUM, True), "delta",
                es)
            paths["sum", True] = jq.last_path
        out[name] = (es, x, buf, res, paths)
    return out


def host_finish(red: torch.Tensor, tail: np.ndarray, op: str, udt):
    """The device's (D,) int32 and the verbatim tail's rows -> the query's
    result, as the port's query finishes it on the host."""
    dev = red.numpy().astype(np.int64)
    if op == "sum":
        return dev + tail.sum(axis=0, dtype=np.int64)
    if tail.size:
        dev = (np.maximum(dev, tail.max(axis=0)) if op == "max"
               else np.minimum(dev, tail.min(axis=0)))
    return dev.astype(udt)


@pytest.mark.parametrize("store", [False, True])
@pytest.mark.parametrize("layout", ["compact", "fused"])
@pytest.mark.parametrize("op", list(OPS))
@pytest.mark.parametrize("name", STREAMS)
def test_decode_reduce_plain_equals_jax(cases, name, op, layout, store):
    es, x, buf, res, _ = cases[name]
    ng, rem, nd = read_metadata_rle(buf)
    lowdim = nd <= LOWDIM_MAX_NDIMS[es]
    idx = tdec.walk_headers(buf, ng, nd, es, lowdim)
    dense, widths, out_rows = tdec.upload_payload(
        tdec.gather_payloads(buf, idx), idx, CPU)
    ndata = idx.widths.shape[0]
    if layout == "compact":
        gaps = (np.diff(idx.out_rows, append=idx.total_rows)
                - BLOCK_SZ).astype(np.int32)
        vals, red = qk.decode_reduce(dense, widths, 8 * es, op, gaps,
                                     bool(idx.out_rows[0] > 0), store, lowdim)
        rows = (idx.out_rows[:, None] + np.arange(BLOCK_SZ)).reshape(-1)
    else:
        d, w = tdec.place_blocks(dense, widths, out_rows, idx.total_rows)
        vals, red = qk.decode_reduce(d, w, 8 * es, op, store=store,
                                     lowdim=lowdim)
        rows = np.arange(idx.total_rows)
    assert red.dtype == torch.int32 and red.shape == (nd,)
    udt = x.dtype
    tail = x.reshape(-1)[x.size - rem:]
    tail = tail[: tail.size // nd * nd].reshape(-1, nd)
    want = getattr(res[op], op)
    got = host_finish(red, tail, op, udt)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if store:
        assert vals.shape == (len(rows), nd) and ndata
        np.testing.assert_array_equal(tdec.download_values(vals).reshape(-1, nd),
                                      x[rows])
    else:
        assert vals is None
    if name == "u16 wrap" and op == "sum":
        exact = x[: x.shape[0] - rem // nd].sum(axis=0, dtype=np.int64)
        assert (exact > 1 << 31).all() and (red.numpy() < 0).all()


def test_fused_sum_equals_jax(cases):
    """The fused pass's sum (materialize True) equals the compact one's and
    the JAX package's."""
    es, x, buf, res, _ = cases[STREAMS[0]]
    got = tq.query(buf, tq.QueryParams(tq.Operation.REDUCE_SUM, True),
                   "delta", es, device="cpu")
    np.testing.assert_array_equal(got.sum, res["fused sum"].sum)
    np.testing.assert_array_equal(got.sum, res["sum"].sum)
    np.testing.assert_array_equal(got.data, x)


def spy(monkeypatch, module, name: str) -> list:
    """Count the calls of ``module.name`` (a list of their positional
    arguments' count)."""
    calls, real = [], getattr(module, name)

    def counted(*a, **k):
        calls.append(len(a))
        return real(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("name", STREAMS[:4])
def test_delta_query_routes_through_the_epilogue(cases, monkeypatch, name):
    """Delta queries (compact, and fused with materialize) reduce in the
    decode's epilogue and never call reduce_cols; paths as the JAX
    package's."""
    es, x, buf, res, paths = cases[name]
    fused = cases[STREAMS[0]][4]["sum", True]  # the JAX package's with materialize
    epi = spy(monkeypatch, tq, "decode_reduce")
    alone = spy(monkeypatch, tq, "reduce_cols")
    for op, jop in OPS.items():
        for mat in (False, True):
            got = tq.query(buf, tq.QueryParams(tq.Operation[jop], mat),
                           "delta", es, device="cpu")
            assert tq.last_path == (fused if mat else paths[op, False])
            np.testing.assert_array_equal(getattr(got, op),
                                          getattr(res[op], op))
    assert len(epi) == 6 and not alone


def test_xff_query_routes_through_reduce_cols(monkeypatch):
    """An xff query's fused pass decodes, then runs reduce_cols, and never
    the delta epilogue; result and path as the JAX package's."""
    rng = np.random.default_rng(7)
    x = (np.cumsum(rng.integers(-4, 5, (96, 9)), axis=0) % 256).astype(np.uint8)
    buf = tenc.compress(x.reshape(-1), 9, codec="xff", device="cpu")
    want = jq.query(buf, jq.QueryParams(jq.Operation.REDUCE_SUM, False),
                    "xff", 1)
    epi = spy(monkeypatch, tq, "decode_reduce")
    alone = spy(monkeypatch, tq, "reduce_cols")
    got = tq.query(buf, tq.QueryParams(tq.Operation.REDUCE_SUM, False),
                   "xff", 1, device="cpu")
    assert tq.last_path == jq.last_path == "fused"
    np.testing.assert_array_equal(got.sum, want.sum)
    assert len(alone) == 1 and not epi
