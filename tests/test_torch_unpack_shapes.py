"""The delta decode's edge cases (``sprintz_tpu_torch/probes/unpack_cases``)
on the CPU: the plain versions of K1 ``unpack_zz`` (biased deltas and tile
offsets), K4 ``unpack_rows``, K5 (its narrow mode) and K2
``prefix_finish``, with the walk's u8 widths, against the JAX package's
Pallas kernels in interpret mode, bit-exact. ``chip_smoke.py`` holds the
kernels to these plain versions at the same cases on the card.

The JAX K1 picks a tile that divides nb (one block where nb is odd), so
its tile totals are summed into the port's tiles of 32 blocks before
their exclusive scan; its K2 takes whole tiles, so a ragged last tile is
padded with zero deltas for it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sprintz_tpu.ops import pallas_decode as jpd
from sprintz_tpu.ops.pallas_pack import unpack_rows_pallas, unpack_rows_pallas_mxu
from sprintz_tpu_torch.ops import decode_kernels as dk
from sprintz_tpu_torch.ops import pack_kernels as pk
from sprintz_tpu_torch.probes import unpack_cases as uc

IDS = [f"u{eb}-D{nd}-nb{nb}-{kind.replace(' ', '_')}"
       for eb, nd, nb, kind in uc.UNPACK_CASES]


def case(eb, ndims, nb, kind):
    rng = np.random.default_rng(eb * 7919 + ndims * 31 + nb)
    dense, widths, fields = uc.unpack_case(rng, eb, ndims, nb, kind)
    d, w = uc.to_device(dense, widths, kind, "cpu")
    return dense, widths, fields, d, w


def jax_tile_offsets(tots: np.ndarray, nb: int) -> np.ndarray:
    """The JAX K1's totals, (nb / t, 1, D) over tiles of t blocks (t
    divides 32), as the exclusive offsets of the port's 32-block tiles."""
    t = nb // tots.shape[0]
    assert dk.TILE_BLOCKS % t == 0
    per = dk.TILE_BLOCKS // t
    ntiles = -(-nb // dk.TILE_BLOCKS)
    tots = np.concatenate([tots, np.zeros((ntiles * per - tots.shape[0],)
                                          + tots.shape[1:], tots.dtype)])
    sums = tots.reshape(ntiles, per, 1, -1).sum(axis=1, dtype=np.int64)
    excl = np.cumsum(sums, axis=0) - sums
    return ((excl + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)


@pytest.mark.parametrize("eb,ndims,nb,kind", uc.UNPACK_CASES, ids=IDS)
def test_unpack_zz_case(eb, ndims, nb, kind):
    dense, widths, fields, d, w = case(eb, ndims, nb, kind)
    bz, toff = dk.unpack_zz(d, w, eb)
    jbz, jtots = jpd.unpack_zz(jnp.asarray(dense), jnp.asarray(widths, jnp.int32),
                               eb, tile=dk.TILE_BLOCKS, interpret=True)
    np.testing.assert_array_equal(dk.widen(bz).numpy(),
                                  np.asarray(jbz).astype(np.int64))
    np.testing.assert_array_equal(toff.numpy(),
                                  jax_tile_offsets(np.asarray(jtots), nb))
    deltas = (fields >> 1) ^ -(fields & 1)
    np.testing.assert_array_equal(dk.widen(bz).numpy(), deltas + (1 << (eb - 1)))


@pytest.mark.parametrize("eb,ndims,nb,kind", uc.UNPACK_CASES, ids=IDS)
def test_unpack_rows_case(eb, ndims, nb, kind):
    dense, widths, fields, d, w = case(eb, ndims, nb, kind)
    got = pk.unpack_rows(d, w)
    assert got.dtype == torch.int32
    want = unpack_rows_pallas(jnp.asarray(dense, jnp.int32),
                              jnp.asarray(widths, jnp.int32), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), fields)


U8_CASES = [c for c in uc.UNPACK_CASES if c[0] == 8]


@pytest.mark.parametrize("eb,ndims,nb,kind", U8_CASES,
                         ids=[i for i, c in zip(IDS, uc.UNPACK_CASES) if c[0] == 8])
def test_unpack_rows_narrow_case(eb, ndims, nb, kind):
    """K5: the MXU kernel's bf16 output, exact for u8 fields. That kernel
    packs a field's bit offset in 12 bits, so rows of 4096 bits or more
    (the wide case) are held to K4's Pallas kernel instead."""
    dense, widths, fields, d, w = case(eb, ndims, nb, kind)
    got = pk.unpack_rows(d, w, narrow=True)
    assert got.dtype == torch.uint8
    jd, jw = jnp.asarray(dense), jnp.asarray(widths, jnp.int32)
    if ndims * eb < 4096:
        want = unpack_rows_pallas_mxu(jd, jw, interpret=True,
                                      out_dtype="bf16").astype(jnp.int32)
    else:
        want = unpack_rows_pallas(jd.astype(jnp.int32), jw, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), fields)


@pytest.mark.parametrize("eb,ndims,nb,kind", uc.UNPACK_CASES, ids=IDS)
def test_prefix_finish_case(eb, ndims, nb, kind):
    """K2 on K1's output at the case: against the JAX K2 (the last tile
    padded to a whole one with zero deltas) and the running sum."""
    _, _, fields, d, w = case(eb, ndims, nb, kind)
    bz, toff = dk.unpack_zz(d, w, eb)
    bz = bz.reshape(-1, ndims)
    got = dk.widen(dk.prefix_finish(bz, toff, eb)).numpy()
    rows = bz.shape[0]
    pad = -rows % dk.TILE_ROWS
    jbz = np.concatenate([dk.widen(bz).numpy(),
                          np.full((pad, ndims), 1 << (eb - 1))])
    want = jpd.prefix_finish(jnp.asarray(jbz, jnp.uint8 if eb == 8 else jnp.uint16),
                             jnp.asarray(toff.numpy()), eb, dk.TILE_ROWS,
                             interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want)[:rows].astype(np.int64))
    deltas = ((fields >> 1) ^ -(fields & 1)).reshape(rows, ndims)
    np.testing.assert_array_equal(got, np.cumsum(deltas, axis=0) % (1 << eb))
