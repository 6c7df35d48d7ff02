"""The port's batch API against the JAX package's for FIRE (xff), at the
shapes of ``test_torch_batch.py``: ``compress_batch`` bytes equal the JAX
package's and each stream's own ``compress`` (FIRE runs S * D lanes wide
from the zero state in every column), and ``decompress_batch`` (each
stream a chunk of ``fire_decode_chunks``) equals the JAX package's and the
input. Apart from the delta cases because the JAX package compiles a
vmapped FIRE scan a case."""

import numpy as np
import pytest

from test_torch_batch import (BATCH_SHAPES, assert_batch_equals_jax,
                              batch_streams)


@pytest.mark.parametrize("es,ndims,nstreams,nrows", BATCH_SHAPES)
def test_xff_batch_equals_jax(es, ndims, nstreams, nrows):
    rng = np.random.default_rng(es * 100 + ndims * 10 + nstreams + 1)
    assert_batch_equals_jax(batch_streams(rng, es, ndims, nstreams, nrows),
                            "xff")
