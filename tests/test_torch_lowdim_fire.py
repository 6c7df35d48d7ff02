"""FIRE's full-precision coefficient (``truncate_coeffs=False``, the
lowdim layout's ``counter >> 1``) in the PyTorch port against the JAX
package: the block-wise plain versions (what ``csrc/fire.cu``'s
``TRUNC=false`` kernels are held to on the card) and the line-by-line
``_fire_scan_plain``, from the zero state and from carried states whose
counter wraps (16 bits at u8, 32 at u16) and whose u16 products
``prev_delta * coef`` wrap in int32. Every comparison is bit-exact."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sprintz_tpu.models import forecasters as jf
from sprintz_tpu_torch.models import forecasters as fc
from sprintz_tpu_torch.ops import decode_kernels as dk
from test_torch_fire import fire_stream


def port_encode(x: np.ndarray, eb: int) -> np.ndarray:
    return fc.fire_encode(torch.from_numpy(x), eb, truncate_coeffs=False).numpy()


def port_decode(errs: np.ndarray, eb: int, init_state=None) -> np.ndarray:
    t = torch.from_numpy(errs.astype(np.uint8 if eb == 8 else np.int32))
    return dk.widen(fc.fire_decode(t, eb, init_state,
                                   truncate_coeffs=False)).numpy()


def oracle_scan(x: np.ndarray, eb: int, decode: bool, init_state=None):
    n, ndims = x.shape
    out = fc._fire_scan_plain(
        torch.from_numpy(x.astype(np.int64)).reshape(-1, 8, ndims), eb,
        decode, init_state, truncate_coeffs=False)
    return out.reshape(n, ndims).numpy()


def jax_scan(x: np.ndarray, eb: int, decode: bool, init_state=None):
    """JAX's full-precision scan: (out (N, D), the carry before each block)."""
    n, ndims = x.shape
    out, states = jf._fire_scan(
        jnp.asarray(x.reshape(n // 8, 8, ndims)), eb, False, decode,
        init_state=init_state, return_states=True)
    return np.asarray(out).reshape(n, ndims), np.asarray(states)


@pytest.mark.parametrize("eb", [8, 16])
def test_full_precision_fire_matches_jax(rng, eb):
    """Random, walk, steady and extreme streams side by side as dims, 41
    blocks (D 1-4 is the lowdim layout's, but FIRE keeps one state per dim,
    so twelve dims cover them): encode from the zero state, decode back and
    from a carried state, against JAX and the line-by-line oracle."""
    x = np.concatenate([fire_stream(rng, kind, 41, 3, eb) for kind in
                        ("rand", "walk", "steady", "extreme")], axis=1)
    errs = port_encode(x, eb)
    np.testing.assert_array_equal(
        errs, np.asarray(jf.fire_encode(jnp.asarray(x), eb,
                                        truncate_coeffs=False)))
    np.testing.assert_array_equal(errs, oracle_scan(x, eb, decode=False))
    assert not np.array_equal(errs, fc.fire_encode(torch.from_numpy(x), eb).numpy())
    np.testing.assert_array_equal(port_decode(errs, eb), x)
    half = 1 << (eb - 1)
    init = np.stack([rng.integers(0, 2 * half, 12), rng.integers(-half, half, 12),
                     rng.integers(-(1 << 15), 1 << 15, 12)]).astype(np.int32)
    got = port_decode(errs, eb, init)
    np.testing.assert_array_equal(got, np.asarray(jf.fire_decode(
        jnp.asarray(errs), eb, truncate_coeffs=False, init_state=init)))
    np.testing.assert_array_equal(
        got, oracle_scan(errs, eb, decode=True, init_state=init))


def wrap_stream(eb: int, nb: int = 300, ndims: int = 3):
    """A steady stream that drives the learning counter up and a state
    whose counter starts 20 blocks' climb below its top (the full
    coefficient at u16 is then about 2^30); the counter's top."""
    if eb == 8:
        steps = np.tile([1, 127], nb * 4)
        top, climb = (1 << 15) - 1, 1
    else:
        steps = np.full(nb * 8, 8000)
        top, climb = (1 << 31) - 1, 8000
    x = (np.cumsum(steps) % (1 << eb)).astype(np.int32)[:, None].repeat(
        ndims, 1)
    init = np.zeros((3, ndims), np.int32)
    init[2] = top - 20 * climb
    return x, init, top


@functools.cache
def wrap_reference(eb: int):
    x, init, top = wrap_stream(eb)
    return x, init, top, jax_scan(x, eb, decode=False, init_state=init)


@pytest.mark.parametrize("eb", [8, 16])
def test_full_precision_fire_counter_and_product_wrap(eb):
    """The counter wraps at its width from a carried state; at u16 the full
    coefficient times the previous delta passes 2^31, so JAX's int32
    product wraps, and the port's int64 one must keep the same bits. The
    errors JAX makes from that state decode back to the stream in the
    port, block-wise and line by line, and the port's encode from that
    state (the oracle) makes JAX's errors."""
    x, init, top, (errs, states) = wrap_reference(eb)
    counter = states[:, 2, 0].astype(np.int64)
    assert (np.diff(counter) < -top).any()  # wrapped from top to bottom
    if eb == 16:
        coef = counter >> 1
        assert (np.abs(coef * 8000) >= 1 << 31).any()  # the product wraps
    np.testing.assert_array_equal(
        oracle_scan(x, eb, decode=False, init_state=init), errs)
    for state in (init, torch.from_numpy(init)):
        np.testing.assert_array_equal(port_decode(errs, eb, state), x)
    np.testing.assert_array_equal(
        oracle_scan(errs, eb, decode=True, init_state=init), x)
    errs0 = port_encode(x, eb)  # and from the zero state
    np.testing.assert_array_equal(errs0, jax_scan(x, eb, decode=False)[0])
    np.testing.assert_array_equal(port_decode(errs0, eb), x)
