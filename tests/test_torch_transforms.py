"""The standalone transforms in the PyTorch port
(``sprintz_tpu_torch/transforms.py``: delta, doubledelta, and xff with the
preprocessor's FIRE) against the JAX package's ``transforms.py``: bytes
equal bytes and values equal values (tolerance 0), at u8 and u16, at
ndims 1, 2, 3, 5 and 33 (odd D exercises the u8 parity rule), at lengths
shorter than a block, where ``_xff_nblocks`` clips the FIRE head, and not a
multiple of D; with and without the header, in place, and with the JAX
package's validation errors. The xff head compiles a JAX scan a shape, so
its lengths are few."""

import itertools

import numpy as np
import pytest

from sprintz_tpu import transforms as jt
from sprintz_tpu_torch import transforms as pt

NDIMS = (1, 2, 3, 5, 33)


def rows_data(rng, n: int, elem_sz: int) -> np.ndarray:
    """n elements, a walk over the first half and random after it."""
    hi = 1 << (8 * elem_sz)
    x = np.cumsum(rng.integers(-40, 41, n))
    x[n // 2:] = rng.integers(0, hi, n - n // 2)
    return (x % hi).astype(np.uint8 if elem_sz == 1 else np.uint16)


def xff_lengths(ndims: int, elem_sz: int) -> list[int]:
    """A length shorter than a block, and one where the overrun guard
    clips the FIRE head (a trailing part shorter than the 32-byte vector's
    overrun), not a multiple of D where D > 1: one JAX scan a case."""
    vector = 32 // elem_sz
    overrun = vector - ndims % vector
    part = next(r for r in range(overrun - 1, 0, -1)
                if ndims == 1 or r % ndims)
    clipped = 8 * ndims * 12 + part
    assert pt._xff_nblocks(clipped, ndims, elem_sz) < clipped // (8 * ndims)
    return [5, clipped]


@pytest.mark.parametrize("ndims", NDIMS)
@pytest.mark.parametrize("elem_sz", [1, 2])
@pytest.mark.parametrize("kind", ["delta", "doubledelta"])
def test_lag_transforms_match_jax(rng, kind, elem_sz, ndims):
    for n in (0, 1, ndims - 1, 7, 8 * ndims + 3, 40000 * 2 + 1):
        x = rows_data(rng, max(n, 0), elem_sz)
        for write_size in (False, True):  # the stream with its header last
            want = jt.transform_encode(x, kind, ndims=ndims,
                                       write_size=write_size)
            got = pt.transform_encode(x, kind, ndims=ndims,
                                      write_size=write_size, device="cpu")
            assert got == want, (kind, elem_sz, ndims, n, write_size)
        out = pt.transform_decode(want, kind, elem_sz, device="cpu")
        assert out.dtype == x.dtype and np.array_equal(out, x)


@pytest.mark.parametrize("ndims", NDIMS)
@pytest.mark.parametrize("elem_sz", [1, 2])
def test_xff_transform_matches_jax(rng, elem_sz, ndims):
    for n in xff_lengths(ndims, elem_sz):
        x = rows_data(rng, n, elem_sz)
        want = jt.transform_encode(x, "xff", ndims=ndims)
        got = pt.transform_encode(x, "xff", ndims=ndims, device="cpu")
        assert got == want, (elem_sz, ndims, n)
        out = pt.transform_decode(want, "xff", elem_sz, device="cpu")
        assert out.dtype == x.dtype and np.array_equal(out, x), (elem_sz,
                                                                  ndims, n)
        body = pt.transform_encode(x, "xff", ndims=ndims, write_size=False,
                                   device="cpu")
        assert body == want[6:]
        np.testing.assert_array_equal(
            pt.transform_decode(body, "xff", elem_sz, ndims=ndims, n=n,
                                device="cpu"), x)


@pytest.mark.parametrize("kind,elem_sz", itertools.product(pt.KINDS, [1, 2]))
def test_transform_2d_input(rng, kind, elem_sz):
    """A (rows, D) array takes D from its shape (the JAX package's bytes
    for the lag kinds; xff's flat stream's, which the JAX package's are
    above)."""
    x = rows_data(rng, 8 * 3 * 17, elem_sz).reshape(-1, 3)
    want = (pt.transform_encode(x.reshape(-1), kind, ndims=3, device="cpu")
            if kind == "xff" else jt.transform_encode(x, kind))
    assert pt.transform_encode(x, kind, device="cpu") == want


@pytest.mark.parametrize("kind", pt.KINDS)
def test_transform_inplace(rng, kind):
    x = rows_data(rng, 1000, 1)
    body = np.frombuffer(pt.transform_encode(x, kind, ndims=8,
                                             write_size=False, device="cpu"),
                         np.uint8)
    buff = np.concatenate([body, np.full(64, 7, np.uint8)])
    out = pt.transform_decode_inplace(buff, x.size, 8, kind, device="cpu")
    np.testing.assert_array_equal(out, x)
    np.testing.assert_array_equal(buff[:x.size], x)
    assert (buff[x.size:] == 7).all()


def test_transform_validation():
    for mod in (jt, pt):
        kw = {} if mod is jt else {"device": "cpu"}
        with pytest.raises(ValueError):
            mod.transform_encode(np.zeros(8, np.uint8), "nope", **kw)
        with pytest.raises(TypeError):
            mod.transform_encode(np.zeros(8, np.int32), "delta", **kw)
        with pytest.raises(TypeError):
            mod.transform_encode(np.zeros(8, np.uint32), "xff", **kw)
        with pytest.raises(ValueError):
            mod.transform_decode(b"\0" * 6, "nope", 1, **kw)
        with pytest.raises(ValueError):  # a body shorter than its header says
            mod.transform_decode(b"\x10\0\0\0\x01\0" + b"\0" * 8, "delta", 1,
                                 **kw)
        with pytest.raises(TypeError):
            mod.transform_decode_inplace(np.zeros(8, np.int16), 8, 1, "delta",
                                         **kw)
