"""The port's query pushdown (``sprintz_tpu_torch.query``) against the JAX
package's (``sprintz_tpu.query``) on the same bytes, exactly (integers: the
tolerance is zero), ``last_path`` too: delta at every op and materialize
flag in both layouts, u8 and u16; streams with leading, middle and
trailing runs, all-run, verbatim and all-tail streams (both codecs); the
u16 sum that wraps past 2^31. FIRE's op matrix is in
``test_torch_query_xff.py``."""

import numpy as np
import pytest

from sprintz_tpu import encoder as jenc
from sprintz_tpu.query import pushdown as jq
from sprintz_tpu_torch import encoder as tenc
from sprintz_tpu_torch import query as tquery
from sprintz_tpu_torch.query import pushdown as tq

OPS = ["NOOP", "REDUCE_MAX", "REDUCE_SUM", "REDUCE_MIN"]
# (elem_sz, ndims): row-major u8 and u16, lowdim u8 and u16
SHAPES = [(1, 9), (2, 5), (1, 3), (2, 2)]


def runs_stream(rng, es: int, ndims: int, nrows: int = 603) -> np.ndarray:
    """A walk with a leading run of zeros, a run in the middle, a run to the
    end of the blocks and a verbatim tail (603 rows)."""
    dt = np.uint8 if es == 1 else np.uint16
    x = (np.cumsum(rng.integers(-5, 6, (nrows, ndims)), axis=0)
         % (1 << (8 * es))).astype(dt)
    x[:40] = 0
    x[200:300] = x[199]
    x[-60:] = x[-61]
    return x


def assert_same_query(buf: bytes, codec: str, es: int, op: str, mat: bool):
    want = jq.query(buf, jq.QueryParams(jq.Operation[op], mat), codec, es)
    got = tq.query(buf, tq.QueryParams(tq.Operation[op], mat), codec, es,
                   device="cpu")
    assert tq.last_path == jq.last_path
    for field in ("data", "max", "sum", "min"):
        w, g = getattr(want, field), getattr(got, field)
        assert (w is None) == (g is None), field
        if w is not None:
            assert g.dtype == w.dtype and g.shape == w.shape, field
            np.testing.assert_array_equal(g, w, err_msg=field)
    return got


@pytest.mark.parametrize("mat", [False, True])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("es,ndims", SHAPES)
def test_delta_query_equals_jax(es, ndims, op, mat):
    rng = np.random.default_rng(es * 10 + ndims)
    x = runs_stream(rng, es, ndims)
    buf = tenc.compress(x.reshape(-1), ndims, device="cpu")
    assert buf == jenc.compress(x.reshape(-1), ndims)
    got = assert_same_query(buf, "delta", es, op, mat)
    if mat:
        np.testing.assert_array_equal(got.data, x)


def edge_streams(es: int):
    """(name, rows, ndims): an all-run stream (zeros), a constant stream
    (one data block, then runs), a verbatim stream, an all-tail stream (one
    block of 20 dims: no group), a stream with runs only at its ends."""
    dt = np.uint8 if es == 1 else np.uint16
    top = (1 << (8 * es)) - 1
    ends = np.zeros((400, 3), dt)
    ends[100:300] = np.arange(200 * 3).reshape(200, 3) % top
    return [("all-run", np.zeros((800, 9), dt)),
            ("constant", np.full((800, 5), top, dt)),
            ("verbatim", np.arange(60, dtype=dt).reshape(-1, 3)),
            ("all-tail", (np.arange(300) % top).astype(dt).reshape(15, 20)),
            ("runs at the ends", ends)]


@pytest.mark.parametrize("mat", [False, True])
@pytest.mark.parametrize("op", ["REDUCE_SUM", "REDUCE_MIN"])
@pytest.mark.parametrize("es", [1, 2])
@pytest.mark.parametrize("kind", range(5))
def test_delta_edge_streams_equal_jax(kind, es, op, mat):
    name, x = edge_streams(es)[kind]
    buf = tenc.compress(x.reshape(-1), x.shape[1], device="cpu")
    got = assert_same_query(buf, "delta", es, op, mat)
    if mat:
        np.testing.assert_array_equal(got.data, x)


@pytest.mark.parametrize("kind", [0, 2, 3])
def test_xff_edge_streams_equal_jax(kind):
    name, x = edge_streams(1)[kind]
    buf = tenc.compress(x.reshape(-1), x.shape[1], codec="xff",
                        device="cpu")
    assert_same_query(buf, "xff", 1, "REDUCE_MAX", True)


@pytest.mark.parametrize("mat", [False, True])
def test_u16_sum_wraps_like_jax(mat):
    """A u16 delta stream of 40000 x 3 values near 65000: the sums wrap
    past 2^31 in int32 on both paths, as in the JAX package (and the
    reference's i32 accumulators), unlike numpy's int64 sums."""
    rng = np.random.default_rng(5)
    x = (65000 + rng.integers(0, 535, (40000, 3))).astype(np.uint16)
    buf = tenc.compress(x.reshape(-1), 3, device="cpu")
    got = assert_same_query(buf, "delta", 2, "REDUCE_SUM", mat)
    exact = x.sum(axis=0, dtype=np.int64)
    wrapped = ((exact + (1 << 31)) % (1 << 32)) - (1 << 31)
    np.testing.assert_array_equal(got.sum, wrapped)
    assert (got.sum < 0).all() and (exact > 1 << 31).all()


def test_query_is_exported_and_defaults_to_the_card():
    assert tquery.query is tq.query
    buf = tenc.compress(np.zeros(400, np.uint8), 4, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tq.query(buf, tq.QueryParams(tq.Operation.REDUCE_SUM, False))
