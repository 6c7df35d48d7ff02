"""Checkpoint sidecars in the PyTorch port against the JAX package, row-major
layout: ``checkpoint.compress_with_sidecar`` gives the same stream bytes
and the same ``Sidecar.to_bytes()``, and ``decompress_parallel`` the same
values, at ``tests/test_checkpoint.py``'s cases (D 24, u8 and u16, delta
and xff, random, sparse and all-zero data); also from a sidecar with one
state row changed, and both packages refuse a sidecar whose row offsets
run backwards. The port runs on the CPU (the kernels' plain versions);
each case's JAX results are computed once and shared by its tests."""

import functools

import numpy as np
import pytest

from sprintz_tpu import checkpoint as jc
from sprintz_tpu.errors import CorruptStreamError as JaxCorrupt
from sprintz_tpu_torch import checkpoint as pc
from sprintz_tpu_torch.errors import CorruptStreamError

from conftest import make_stream

D = 24
NROWS = 3000
CASES = [(codec, es, kind) for codec in ("delta", "xff") for es in (1, 2)
         for kind in ("rand", "sparse", "zeros")]


@functools.cache
def case_data(codec: str, es: int, kind: str):
    """(input, JAX stream, JAX sidecar, JAX decompress_parallel values) of a
    case, from a seed of its own."""
    rng = np.random.default_rng(
        [CASES.index((codec, es, kind)), 123])
    flat = make_stream(rng, NROWS * D, es, kind)
    stream, sc = jc.compress_with_sidecar(flat, D, codec=codec,
                                          every_groups=16)
    return flat, stream, sc, jc.decompress_parallel(stream, sc)


@functools.cache
def port_data(codec: str, es: int, kind: str):
    flat = case_data(codec, es, kind)[0]
    return pc.compress_with_sidecar(flat, D, codec=codec, every_groups=16,
                                    device="cpu")


@pytest.mark.parametrize("codec,es,kind", CASES)
def test_stream_and_sidecar_bytes_equal_jax(codec, es, kind):
    _, jstream, jsc, _ = case_data(codec, es, kind)
    stream, sc = port_data(codec, es, kind)
    assert stream == jstream
    assert sc.to_bytes() == jsc.to_bytes()
    back = pc.Sidecar.from_bytes(sc.to_bytes())
    assert back.to_bytes() == sc.to_bytes() and back.codec == codec


@pytest.mark.parametrize("codec,es,kind", CASES)
def test_decompress_parallel_equals_jax(codec, es, kind):
    flat, _, _, jvals = case_data(codec, es, kind)
    stream, sc = port_data(codec, es, kind)
    got = pc.decompress_parallel(stream, sc, device="cpu")
    assert got.dtype == flat.dtype
    np.testing.assert_array_equal(got, jvals)
    np.testing.assert_array_equal(got, flat)


@pytest.mark.parametrize("codec", ["delta", "xff"])
def test_changed_state_row_follows_jax(codec):
    """A sidecar with one checkpoint's state changed (a value, and for FIRE
    a delta wider than an element and a counter): the chunk from it
    decodes from that state in both packages, the other chunks as the
    stream."""
    flat, jstream, jsc, _ = case_data(codec, 1, "rand")
    stream, _ = port_data(codec, 1, "rand")
    bad = pc.Sidecar.from_bytes(jsc.to_bytes())
    assert len(bad.byte_offsets) > 3
    bad.states[2] = bad.states[2] * 3 + 11
    if codec == "xff":
        bad.states[2, 1] += 1 << 12
    want = jc.decompress_parallel(jstream, jc.Sidecar.from_bytes(
        bad.to_bytes()))
    got = pc.decompress_parallel(stream, bad, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, flat)


def test_reversed_row_offsets_raise_in_both():
    flat = make_stream(np.random.default_rng(7), 4000 * 8, 1, "sparse")
    stream, sc = pc.compress_with_sidecar(flat, 8, codec="delta",
                                          every_groups=16, device="cpu")
    bad = pc.Sidecar.from_bytes(sc.to_bytes())
    bad.row_offsets = bad.row_offsets[::-1].copy()
    with pytest.raises(CorruptStreamError):
        pc.decompress_parallel(stream, bad, device="cpu")
    with pytest.raises(JaxCorrupt):
        jc.decompress_parallel(stream, jc.Sidecar.from_bytes(bad.to_bytes()))
