"""Checkpoint sidecars in the PyTorch port against the JAX package, beyond
the row-major chunk-parallel decode: the lowdim layout ((3, 1), (2, 2),
(1, 1) as (ndims, elem_sz)), ``decode_range`` at
``tests/test_checkpoint.py``'s ranges, a stream of one checkpoint and a
verbatim one (the serial decode's route), and ``SprintzCodec``'s
``compress_seekable`` and ``decompress(sidecar=)`` with and without +Huf.
Stream bytes, sidecar bytes and values equal the JAX package's; the port
runs on the CPU."""

import functools

import numpy as np
import pytest

from sprintz_tpu import checkpoint as jc
from sprintz_tpu.api import SprintzCodec as JaxCodec
from sprintz_tpu_torch import SprintzCodec, checkpoint as pc

from conftest import make_stream

LOWDIM = [(codec, nd, es) for codec in ("delta", "xff")
          for nd, es in ((3, 1), (2, 2), (1, 1))]
RANGES = [(0, 64), (997, 400), (2500, 1000), (4800, 150)]


def both(flat, ndims, codec, every):
    js, jsc = jc.compress_with_sidecar(flat, ndims, codec=codec,
                                       every_groups=every)
    ps, psc = pc.compress_with_sidecar(flat, ndims, codec=codec,
                                       every_groups=every, device="cpu")
    assert ps == js
    assert psc.to_bytes() == jsc.to_bytes()
    return js, jsc, ps, psc


@pytest.mark.parametrize("codec,ndims,es", LOWDIM)
def test_lowdim_sidecar_equals_jax(codec, ndims, es):
    rng = np.random.default_rng([LOWDIM.index((codec, ndims, es)), 5])
    flat = make_stream(rng, 2048 * ndims, es, "sparse")
    js, jsc, ps, psc = both(flat, ndims, codec, 8)
    assert len(psc.byte_offsets) > 2
    got = pc.decompress_parallel(ps, psc, device="cpu")
    np.testing.assert_array_equal(got, jc.decompress_parallel(js, jsc))
    np.testing.assert_array_equal(got, flat)


@functools.cache
def range_case(codec: str):
    rows = make_stream(np.random.default_rng([11, codec == "xff"]),
                       5000 * 9, 1, "sparse").reshape(5000, 9)
    js, jsc, ps, psc = both(rows.reshape(-1), 9, codec, 16)
    return rows, js, jsc, ps, pc.Sidecar.from_bytes(psc.to_bytes())


@pytest.mark.parametrize("start,n", RANGES)
@pytest.mark.parametrize("codec", ["delta", "xff"])
def test_decode_range_equals_jax(codec, start, n):
    rows, js, jsc, ps, psc = range_case(codec)
    got = pc.decode_range(ps, psc, start, n, device="cpu")
    np.testing.assert_array_equal(got, jc.decode_range(js, jsc, start, n))
    np.testing.assert_array_equal(got, rows[start: start + n])


@pytest.mark.parametrize("n", [64, 400])
def test_verbatim_and_single_checkpoint_streams(n):
    """A verbatim stream (fewer than 128 elements) and one of a single
    checkpoint take the serial decode, in both packages."""
    flat = make_stream(np.random.default_rng(n), n, 1, "rand")
    js, jsc, ps, psc = both(flat, 1, "delta", 1024)
    assert len(psc.byte_offsets) == (0 if n < 128 else 1)
    got = pc.decompress_parallel(ps, psc, device="cpu")
    np.testing.assert_array_equal(got, jc.decompress_parallel(js, jsc))
    np.testing.assert_array_equal(got, flat)


@pytest.mark.parametrize("entropy", ["none", "huffman"])
def test_api_seekable_roundtrip_equals_jax(entropy):
    data = make_stream(np.random.default_rng(3), 4000 * 12, 2,
                       "sparse").reshape(4000, 12)
    port = SprintzCodec("xff", 2, entropy=entropy, device="cpu")
    stream, sc = port.compress_seekable(data)
    jstream, jsc = JaxCodec(codec="xff", elem_sz=2,
                            entropy=entropy).compress_seekable(data)
    assert stream == jstream and sc.to_bytes() == jsc.to_bytes()
    assert stream == port.compress(data)
    np.testing.assert_array_equal(port.decompress(stream, sidecar=sc),
                                  data.reshape(-1))
