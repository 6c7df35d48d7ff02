"""The port's query pushdown against the JAX package's for FIRE (xff):
every op and materialize flag in both layouts, u8 and u16, on a stream
with leading, middle and trailing runs and a verbatim tail, exactly, with
``last_path`` (always "fused": FIRE's runs extrapolate row by row). The
JAX package compiles a fused pass a case (about 3 s), so these live apart
from the delta cases of ``test_torch_query.py``."""

import numpy as np
import pytest

from sprintz_tpu import encoder as jenc
from sprintz_tpu_torch import encoder as tenc

from test_torch_query import OPS, SHAPES, assert_same_query, runs_stream


@pytest.mark.parametrize("mat", [False, True])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("es,ndims", SHAPES)
def test_xff_query_equals_jax(es, ndims, op, mat):
    rng = np.random.default_rng(es * 10 + ndims)
    x = runs_stream(rng, es, ndims, nrows=203)
    buf = tenc.compress(x.reshape(-1), ndims, codec="xff", device="cpu")
    assert buf == jenc.compress(x.reshape(-1), ndims, codec="xff")
    got = assert_same_query(buf, "xff", es, op, mat)
    if mat:
        np.testing.assert_array_equal(got.data, x)
