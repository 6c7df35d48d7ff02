"""FIRE (xff) in the PyTorch port against the JAX package: the forecaster's
plain versions (what the CPU runs and what ``csrc/fire.cu`` is held to on
the card), written block-wise on the identities the kernels rest on and
held to the line-by-line ``_fire_scan_plain`` too, its state carried
across, K4's narrow mode (K5) and the planner's FIRE run comparator. Every
comparison is bit-exact."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sprintz_tpu import planner as jplanner
from sprintz_tpu.models import forecasters as jf
from sprintz_tpu.ops.pack import unpack_rows_rowmajor
from sprintz_tpu.ops.pallas_pack import unpack_rows_pallas_mxu
from sprintz_tpu_torch import planner
from sprintz_tpu_torch.constants import GROUP_SZ_BLOCKS, nbits_sz_bits
from sprintz_tpu_torch.models import forecasters as fc
from sprintz_tpu_torch.ops.bitmath import header_to_width
from sprintz_tpu_torch.ops import decode_kernels as dk
from sprintz_tpu_torch.ops import pack_kernels as pk
from test_torch_codec import plan_tuple
from test_torch_kernels import edge_widths, payload


def fire_stream(rng, kind: str, nb: int, ndims: int, eb: int) -> np.ndarray:
    """(nb * 8, ndims) int32 values in [0, 2^eb)."""
    hi = 1 << eb
    n = nb * 8
    if kind == "rand":
        x = rng.integers(0, hi, (n, ndims))
    elif kind == "walk":
        x = np.cumsum(rng.integers(-(hi >> 5), (hi >> 5) + 1, (n, ndims)), 0)
    elif kind == "steady":  # the counter learns one slope per dim
        x = np.arange(n)[:, None] * rng.integers(-9, 10, ndims)[None, :]
    elif kind == "extreme":  # deltas of +-2^(eb-1) and 2^(eb-1) - 1
        steps = rng.choice([hi >> 1, (hi >> 1) - 1, -(hi >> 1), 1, 0],
                           (n, ndims))
        x = np.cumsum(steps, 0)
    else:
        raise ValueError(kind)
    return (x % hi).astype(np.int32)


def port_encode(x: np.ndarray, eb: int) -> np.ndarray:
    return fc.fire_encode(torch.from_numpy(x), eb).numpy()


def port_decode(errs: np.ndarray, eb: int, init_state=None) -> np.ndarray:
    t = torch.from_numpy(errs.astype(np.uint8 if eb == 8 else np.int32))
    return dk.widen(fc.fire_decode(t, eb, init_state)).numpy()


@pytest.mark.parametrize("eb", [8, 16])
def test_fire_matches_jax(rng, eb):
    """Random, walk, steady and extreme streams side by side as dims: FIRE
    keeps one state per dim, so one scan covers them all."""
    x = np.concatenate([fire_stream(rng, kind, 40, 3, eb) for kind in
                        ("rand", "walk", "steady", "extreme")], axis=1)
    errs = port_encode(x, eb)
    want = np.asarray(jf.fire_encode(jnp.asarray(x), eb))
    np.testing.assert_array_equal(errs, want)
    assert errs.min() >= 0 and errs.max() < (1 << eb)
    vals = port_decode(errs, eb)
    np.testing.assert_array_equal(vals, x)
    np.testing.assert_array_equal(
        vals, np.asarray(jf.fire_decode(jnp.asarray(errs), eb)))


def jax_scan(blocks_in: np.ndarray, eb: int, decode: bool, init_state=None):
    """JAX's FIRE scan from ``init_state``: (out (N, D), the carry before
    each block (nb, 3, D))."""
    n, ndims = blocks_in.shape
    out, states = jf._fire_scan(
        jnp.asarray(blocks_in.reshape(n // 8, 8, ndims)), eb, True, decode,
        init_state=init_state, return_states=True)
    return np.asarray(out).reshape(n, ndims), np.asarray(states)


def wrap_stream(eb: int, nb: int = 300, ndims: int = 3):
    """A steady stream that drives the learning counter up, a state whose
    counter starts 100 blocks below its top, and that top."""
    if eb == 8:
        # deltas 1, 127: the prediction stays below 64, so every odd-row
        # error is positive and the counter climbs by one a block
        steps = np.tile([1, 127], nb * 4)
        top = (1 << 15) - 1
    else:
        steps = np.full(nb * 8, 8000)  # the counter climbs 8000 a block
        top = (1 << 31) - 1
    x = (np.cumsum(steps) % (1 << eb)).astype(np.int32)[:, None].repeat(
        ndims, 1)
    init = np.zeros((3, ndims), np.int32)
    init[2] = top - 100 * (1 if eb == 8 else 8000)
    return x, init, top


@functools.cache
def wrap_reference(eb: int):
    """``wrap_stream(eb)`` through JAX's scan, once a test run (each call of
    the scan compiles it anew): the stream, the state, the counter's top,
    and JAX's errors and per-block states from that state and from the
    zero state."""
    x, init, top = wrap_stream(eb)
    return (x, init, top, jax_scan(x, eb, decode=False, init_state=init),
            jax_scan(x, eb, decode=False))


@pytest.mark.parametrize("eb", [8, 16])
def test_fire_counter_and_coefficient_wrap(eb):
    """The learning counter wraps at its width (16 bits for u8, 32 for
    u16), and the u16 coefficient at 16 bits, as JAX's int32 arithmetic
    does. Steady streams drive the counter over the edge; the 16-bit u8
    counter and the 32-bit u16 one start near it (a state carried in)."""
    x, init, top, (errs, states), (jax_errs0, states0) = wrap_reference(eb)
    counter = states[:, 2, 0].astype(np.int64)
    assert (np.diff(counter) < -top).any()  # wrapped from top to bottom
    np.testing.assert_array_equal(port_decode(errs, eb, init), x)
    np.testing.assert_array_equal(
        port_decode(errs, eb, torch.from_numpy(init)), x)
    if eb == 16:  # from the zero state: the coefficient wraps at 2^16
        errs0 = port_encode(x, eb)
        np.testing.assert_array_equal(errs0, jax_errs0)
        assert states0[:, 2, 0].max() > (1 << 16)
        np.testing.assert_array_equal(
            errs0, np.asarray(jf.fire_encode(jnp.asarray(x), eb)))
        np.testing.assert_array_equal(port_decode(errs0, eb), x)


def oracle_scan(blocks_in: np.ndarray, eb: int, decode: bool, init_state=None):
    """The port's line-by-line ``_fire_scan_plain`` over (N, D)."""
    n, ndims = blocks_in.shape
    out = fc._fire_scan_plain(
        torch.from_numpy(blocks_in.astype(np.int64)).reshape(-1, 8, ndims),
        eb, decode, init_state)
    return out.reshape(n, ndims).numpy()


BLOCKWISE_DIMS = (1, 5, 33, 64, 129)
BLOCKWISE_BLOCKS = (1, 2, 41)


@functools.cache
def blockwise_reference(eb: int):
    """One stream of max(BLOCKWISE_BLOCKS) blocks whose dims are the
    BLOCKWISE_DIMS groups side by side, through JAX's scan once a test run:
    FIRE keeps one state per dim and is causal in rows, so every case's
    stream is a slice of it. Returns the stream, a carried state, JAX's
    errors, and JAX's values decoded from the carried state (from the zero
    state they are the stream)."""
    rng = np.random.default_rng(eb)
    ndims, nb = sum(BLOCKWISE_DIMS), max(BLOCKWISE_BLOCKS)
    kinds = ("rand", "walk", "steady", "extreme")
    x = np.concatenate([fire_stream(rng, kinds[d % 4], nb, 1, eb)
                        for d in range(ndims)], axis=1)
    half = 1 << (eb - 1)
    # a value, a delta (every third dim's wider than its element, which no
    # encoder leaves but JAX's int32 arithmetic takes) and a counter large
    # enough to give a coefficient
    wide = np.where(np.arange(ndims) % 3 == 0, 1 << 20, half)
    init = np.stack([rng.integers(0, 2 * half, ndims),
                     rng.integers(-wide, wide),
                     rng.integers(-(1 << 15), 1 << 15, ndims)]
                    ).astype(np.int32)
    errs = jax_scan(x, eb, decode=False)[0]
    return x, init, errs, jax_scan(errs, eb, decode=True, init_state=init)[0]


@pytest.mark.parametrize("nb", BLOCKWISE_BLOCKS)
@pytest.mark.parametrize("ndims", BLOCKWISE_DIMS)
@pytest.mark.parametrize("eb", [8, 16])
def test_fire_blockwise_matches_jax_and_the_oracle(eb, ndims, nb):
    """The block-wise plain FIRE (deltas ahead of the state, a block's rows
    at once, one sign extension of the gradient sum, values by cumsum)
    against JAX's ``_fire_scan`` and the line-by-line oracle: encode from
    the zero state, decode from the zero state and from a carried one; on
    random errors, which no encoder makes, against the oracle."""
    x, init, jax_errs, jax_vals_carried = blockwise_reference(eb)
    first = sum(BLOCKWISE_DIMS[:BLOCKWISE_DIMS.index(ndims)])
    cut = (slice(0, nb * 8), slice(first, first + ndims))
    x, init = np.ascontiguousarray(x[cut]), np.ascontiguousarray(init[:, cut[1]])
    errs = port_encode(x, eb)
    np.testing.assert_array_equal(errs, oracle_scan(x, eb, decode=False))
    np.testing.assert_array_equal(errs, jax_errs[cut])
    for state, want in ((None, x), (init, jax_vals_carried[cut])):
        got = port_decode(errs, eb, state)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, oracle_scan(errs, eb, decode=True, init_state=state))
    rng = np.random.default_rng(1000 * eb + 10 * ndims + nb)
    noise = rng.integers(0, 1 << eb, errs.shape).astype(np.int32)
    for state in (None, init):
        np.testing.assert_array_equal(
            port_decode(noise, eb, state),
            oracle_scan(noise, eb, decode=True, init_state=state))


@pytest.mark.parametrize("eb", [8, 16])
def test_fire_blockwise_on_the_wrap_streams(eb):
    """The same two versions and JAX where the counter wraps (from a carried
    state, both widths) and where the u16 coefficient wraps at 2^16 (from
    the zero state)."""
    x, init, top, (errs, states), (jax_errs0, _) = wrap_reference(eb)
    assert (np.diff(states[:, 2, 0].astype(np.int64)) < -top).any()
    got = port_decode(errs, eb, init)
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(
        got, oracle_scan(errs, eb, decode=True, init_state=init))
    errs0 = port_encode(x, eb)
    np.testing.assert_array_equal(errs0, oracle_scan(x, eb, decode=False))
    np.testing.assert_array_equal(errs0, jax_errs0)
    np.testing.assert_array_equal(
        port_decode(errs0, eb), oracle_scan(errs0, eb, decode=True))


@pytest.mark.parametrize("eb,ndims", [(8, 9), (16, 5)])
def test_fire_decode_from_a_mid_stream_state(rng, eb, ndims):
    """The (3, D) carry JAX records before block k (its sidecar state)
    enters both packages' decode of blocks k onwards."""
    x = fire_stream(rng, "walk", 48, ndims, eb)
    errs, states = jf.fire_encode_with_states(jnp.asarray(x), eb)
    errs, states = np.asarray(errs), np.asarray(states)
    for k in (1, 17, 47):
        got = port_decode(errs[8 * k:], eb, states[k])
        np.testing.assert_array_equal(got, x[8 * k:])
    np.testing.assert_array_equal(got, np.asarray(jf.fire_decode(
        jnp.asarray(errs[8 * k:]), eb, init_state=states[k])))


def test_fire_wrappers_check_their_inputs():
    rows = torch.zeros((16, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        fc.fire_encode(rows.to(torch.int64), 8)
    with pytest.raises(ValueError):
        fc.fire_encode(rows[:12], 8)
    with pytest.raises(ValueError):
        fc.fire_encode(rows, 12)
    with pytest.raises(TypeError):  # u8 fields at elem_bits 8
        fc.fire_decode(rows, 8)
    with pytest.raises(ValueError, match="init_state"):
        fc.fire_decode(rows, 16, np.zeros((3, 5), np.int32))


def test_unpack_rows_narrow_matches_mxu_bf16(rng):
    """K4's narrow mode (K5) is ``unpack_rows_pallas_mxu``'s bf16 output
    at u8, which is exact there, and ``unpack_rows_rowmajor``'s fields."""
    widths = edge_widths(rng, 64, 11, 8)
    fields, dense = payload(rng, widths, 8)
    w = torch.from_numpy(widths.astype(np.uint8))
    got = pk.unpack_rows(torch.from_numpy(dense), w, narrow=True)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), fields)
    np.testing.assert_array_equal(
        got.numpy(), pk.unpack_rows(torch.from_numpy(dense), w).numpy())
    d = jnp.asarray(dense)
    jw = jnp.asarray(widths, jnp.int32)
    mxu = unpack_rows_pallas_mxu(d, jw, interpret=True, out_dtype="bf16")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(mxu.astype(jnp.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        unpack_rows_rowmajor(d.astype(jnp.int32), jw, elem_sz=1)))


@pytest.mark.parametrize("ndims", [1, 5, 64])
def test_u8_headers_fit_the_narrow_mode(ndims):
    """The decoder's u8 xff path calls ``unpack_rows(narrow=True)``
    unchecked: every 3-bit header, the all-ones one included, decodes to a
    width of at most 8, so every field fits a byte."""
    hdr_bits = nbits_sz_bits(1)
    nbytes = (ndims * hdr_bits * GROUP_SZ_BLOCKS + 7) // 8
    for byte in (0x00, 0x5A, 0xFF):
        hdr = planner.unpack_headers(np.full((1, nbytes), byte, np.uint8), 1,
                                     ndims, hdr_bits)
        widths = header_to_width(hdr.astype(np.int64), 8)
        assert widths.max() <= 8
    assert widths.max() == 8  # all ones: the widest u8 field


@pytest.mark.parametrize("density", [0.0, 0.3, 0.9, 1.0])
@pytest.mark.parametrize("ndims", [5, 64])
def test_build_plan_fire_comparator(rng, density, ndims):
    """Against the JAX planner with row-major FIRE's comparator, which
    lets a run reach the last full group's start; at density 1 every
    length shows where the two comparators part."""
    differs = 0
    for nb in (0, 1, 2, 3, 4, 17, 300):
        for extra in (0, 3, 8 * ndims, 16 * ndims + 1):
            n = nb * 8 * ndims + extra
            flags = rng.random(n // (8 * ndims)) < density
            got = planner.build_plan(flags, n, ndims, True)
            want = jplanner._build_plan_py(flags, n, ndims, True)
            assert plan_tuple(got) == plan_tuple(want), (nb, extra)
            differs += plan_tuple(got) != plan_tuple(
                planner.build_plan(flags, n, ndims))
    assert differs or density < 1
