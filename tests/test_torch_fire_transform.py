"""The standalone preprocessor's FIRE (the xff transform's head) in the
PyTorch port, bit-exact (tolerance 0): the plain line-by-line scan with
``transform=True`` against the JAX package's ``_fire_scan(...,
learning_shift, transform=True)``, at u8 and u16, at odd D (the u8 rule
that even dims multiply the previous delta's low byte zero-extended) and on
a u8 stream whose learning counter wraps at 16 bits; the block-wise plain
versions behind ``fire_encode`` / ``fire_decode(transform=True)`` against
the line-by-line scan; and ``csrc/fire.cu``'s transform instantiations
built on the host with g++ (``probes/host_build.py``, as
``test_torch_host_fire.py`` builds the codec's) against those plain
versions at ``host_build.FIRE_TRANSFORM_CASES``."""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sprintz_tpu.models import forecasters as jf
from sprintz_tpu_torch.models import forecasters as fc
from sprintz_tpu_torch.ops.decode_kernels import widen
from sprintz_tpu_torch.probes import host_build as hb

LEARNING_SHIFT = {8: 1, 16: 3}  # the JAX package's transforms.py:103


def transform_rows(rng, eb: int, nb: int, ndims: int) -> np.ndarray:
    """(nb * 8, D) int32 values: a walk over the first half, random after."""
    hi = 1 << eb
    x = np.cumsum(rng.integers(-(hi >> 4), (hi >> 4) + 1, (nb * 8, ndims)), 0)
    x[nb * 4:] = rng.integers(0, hi, (nb * 8 - nb * 4, ndims))
    return (x % hi).astype(np.int32)


def jax_scan(x: np.ndarray, eb: int, decode: bool, states: bool = False):
    blocks = jnp.asarray(x.reshape(-1, 8, x.shape[1]))
    out = jf._fire_scan(blocks, eb, truncate_coeffs=True, decode=decode,
                        learning_shift=LEARNING_SHIFT[eb], transform=True,
                        return_states=states)
    if states:
        return np.asarray(out[0]).reshape(x.shape), np.asarray(out[1])
    return np.asarray(out).reshape(x.shape)


def plain_scan(x: np.ndarray, eb: int, decode: bool) -> np.ndarray:
    blocks = torch.from_numpy(x.astype(np.int64)).reshape(-1, 8, x.shape[1])
    return fc._fire_scan_plain(blocks, eb, decode,
                               transform=True).reshape(x.shape).numpy()


def signed(errs: np.ndarray, eb: int) -> np.ndarray:
    """Raw errors masked to eb bits -> their signed values."""
    half = 1 << (eb - 1)
    return ((errs.astype(np.int64) + half) % (2 * half) - half).astype(
        np.int32)


@pytest.mark.parametrize("eb", [8, 16])
def test_plain_transform_scan_matches_jax(rng, eb):
    x = transform_rows(rng, eb, 40, 5)
    errs = jax_scan(x, eb, decode=False)
    np.testing.assert_array_equal(plain_scan(x, eb, False), errs)
    np.testing.assert_array_equal(jax_scan(errs, eb, decode=True), x)
    np.testing.assert_array_equal(plain_scan(errs, eb, True), x)


def test_plain_transform_scan_matches_jax_across_counter_wrap():
    """A u8 stream that drives the learning counter past 32767: JAX's
    carries before each block show it wrap, and the plain scan follows."""
    x = hb.wrapping_transform_rows(8, 2, 1100)
    errs, states = jax_scan(x, 8, decode=False, states=True)
    counters = states[:, 2]
    assert counters.max() > 32000 and (np.diff(counters, axis=0) < -60000).any()
    np.testing.assert_array_equal(plain_scan(x, 8, False), errs)
    np.testing.assert_array_equal(plain_scan(errs, 8, True), x)


@pytest.mark.parametrize("eb,ndims", [(8, 1), (8, 6), (8, 33), (16, 1),
                                      (16, 7)])
def test_blockwise_plain_matches_line_by_line(rng, eb, ndims):
    """``fire_encode`` / ``fire_decode`` with ``transform`` on CPU tensors
    (their block-wise plain versions) against ``_fire_scan_plain``: raw
    errors masked to eb bits out, the stored u8 or u16 (as int16) in."""
    x = transform_rows(rng, eb, 30, ndims)
    want = plain_scan(x, eb, False)
    errs = fc.fire_encode(torch.from_numpy(x), eb, transform=True)
    assert errs.dtype == torch.int32
    np.testing.assert_array_equal(signed(errs.numpy(), eb), want)
    raw = (errs.to(torch.uint8) if eb == 8
           else (errs - ((errs & 0x8000) << 1)).to(torch.int16))
    vals = fc.fire_decode(raw, eb, transform=True)
    assert vals.dtype == (torch.uint8 if eb == 8 else torch.uint16)
    np.testing.assert_array_equal(widen(vals).numpy(), x)


def test_transform_arguments():
    rows = torch.zeros((16, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        fc.fire_encode(rows, 8, transform=True, states=True)
    with pytest.raises(ValueError):
        fc.fire_encode(rows, 8, truncate_coeffs=False, transform=True)
    with pytest.raises(ValueError):
        fc.fire_decode(torch.zeros((16, 3), dtype=torch.uint8), 8,
                       init_state=np.zeros((3, 3), np.int32), transform=True)
    with pytest.raises(TypeError):  # u16 raw errors travel as int16
        fc.fire_decode(torch.zeros((16, 3), dtype=torch.int32), 16,
                       transform=True)


@pytest.fixture(scope="module")
def fire_library(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the kernels' host build needs it")
    return hb.build_fire(out=tmp_path_factory.mktemp("host"))


@pytest.mark.parametrize("resident", [1, 2])
@pytest.mark.parametrize("eb,ndims,nb,wraps", hb.FIRE_TRANSFORM_CASES)
def test_host_built_transform_equals_plain(fire_library, resident, eb, ndims,
                                           nb, wraps):
    hk = hb.HostKernels(fire_library, resident)
    assert hb.check_fire_transform_case(hk, eb, ndims, nb, wraps) is None
