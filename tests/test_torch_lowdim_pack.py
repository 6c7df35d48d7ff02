"""The lowdim layout's pack and unpack in the PyTorch port against the JAX
package: the port's lowdim pack (``pack_dims_lowdim_plain``, which the
plain ``encode_lowdim`` ends in and ``csrc/pack.cu``'s
``encode_lowdim_kernel`` is held to on the card) and the plain versions of
the lowdim decode's two modes (``decode_lowdim_kernel`` in
``csrc/decode.cu``) at the cases of ``probes/encode_cases.py`` and
``probes/unpack_cases.py``, and ``block_widths_lowdim``. Every comparison
is exact (integers)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sprintz_tpu.ops import bitmath as jbm
from sprintz_tpu.ops import pack as jpack
from sprintz_tpu_torch.ops import bitmath as bm
from sprintz_tpu_torch.ops import decode_kernels as dk
from sprintz_tpu_torch.ops import pack_kernels as pk
from sprintz_tpu_torch.probes import encode_cases as ec
from sprintz_tpu_torch.probes import unpack_cases as uc


@pytest.mark.parametrize("eb", [8, 16])
def test_block_widths_lowdim_exhaustive(eb):
    """Every block max of eb bits; 7 is a legal width at u16."""
    u = np.arange(1 << eb, dtype=np.int32)
    got = bm.block_widths_lowdim(torch.from_numpy(u), eb // 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbm.block_widths_lowdim(jnp.asarray(u), eb // 8)))
    assert set(np.unique(got.numpy())) == set(ec.lowdim_legal_widths(eb))


@pytest.mark.parametrize("ndims,elem_sz,nb", ec.LOWDIM_PACK_CASES)
def test_pack_lowdim_matches_jax(ndims, elem_sz, nb):
    rng = np.random.default_rng(ndims * 31 + elem_sz * 7 + nb)
    errs, widths = ec.pack_lowdim_case(rng, ndims, elem_sz, nb)
    got = pk.pack_dims_lowdim_plain(torch.from_numpy(errs),
                                    torch.from_numpy(widths), elem_sz)
    want = jpack.pack_dims_lowdim(jnp.asarray(errs), jnp.asarray(widths),
                                  elem_sz)
    assert got.dtype == torch.uint8 and got.shape == (nb, ndims, 8 * elem_sz)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def zz_and_offsets_reference(fields: np.ndarray, eb: int):
    """K1's output contract from zigzag fields (nb, 8, D), in numpy: the
    biased deltas and each 32-block tile's exclusive offset, int32
    wrapping."""
    nb, _, nd = fields.shape
    f = fields.astype(np.int64)
    delta = (f >> 1) ^ -(f & 1)
    biased = (delta + (1 << (eb - 1))).astype(
        np.uint8 if eb == 8 else np.uint16)
    ntiles = -(-nb // dk.TILE_BLOCKS)
    pad = np.zeros((ntiles * dk.TILE_BLOCKS - nb, 8, nd), np.int64)
    tots = np.concatenate([delta, pad]).reshape(ntiles, -1, nd).sum(axis=1)
    excl = np.cumsum(tots, axis=0) - tots
    wrapped = ((excl + (1 << 31)) % (1 << 32)) - (1 << 31)
    return biased, wrapped.astype(np.int32)[:, None, :]


@pytest.mark.parametrize("eb,ndims,nb,kind", uc.LOWDIM_CASES)
def test_unpack_lowdim_matches_jax(eb, ndims, nb, kind):
    """Both modes of the lowdim decode against JAX: the raw fields against
    its ``unpack_dims_lowdim`` (int32 dense and widths, as its docstring
    asks), the values against the running sum of JAX's fields' zigzag
    deltas, and K1's contract on JAX's fields (biased deltas and tile
    offsets, the plain decode's first step); and JAX's pack of the case's
    fields gives the case's dense buffer."""
    rng = np.random.default_rng(eb * 7919 + ndims * 31 + nb)
    dense, widths, fields = uc.lowdim_case(rng, eb, ndims, nb, kind)
    np.testing.assert_array_equal(
        dense, np.asarray(jpack.pack_dims_lowdim(
            jnp.asarray(fields.astype(np.int32)),
            jnp.asarray(widths.astype(np.int32)), eb // 8)))
    jfields = np.asarray(jpack.unpack_dims_lowdim(
        jnp.asarray(dense.astype(np.int32)), jnp.asarray(widths.astype(np.int32))))
    np.testing.assert_array_equal(jfields, fields)
    d, w = uc.to_device(dense, widths, kind, "cpu")
    raw = dk.unpack_dims_lowdim(d, w)
    assert raw.dtype == (torch.uint8 if eb == 8 else torch.int32)
    np.testing.assert_array_equal(raw.numpy().astype(np.int64), jfields)
    bz, toff = dk.zz_and_offsets(dk.extract_fields_lowdim(d, w), eb)
    want_bz, want_toff = zz_and_offsets_reference(jfields, eb)
    np.testing.assert_array_equal(dk.widen(bz).numpy(), want_bz)
    np.testing.assert_array_equal(toff.numpy(), want_toff)
    # the decode's values are the running sum of the deltas
    vals = dk.decode_delta_lowdim(d, w, eb)
    assert vals.dtype == dk.narrow_dtype(eb) and vals.shape == (nb * 8, ndims)
    f = jfields.astype(np.int64).reshape(-1, ndims)
    np.testing.assert_array_equal(
        dk.widen(vals).numpy(), np.cumsum((f >> 1) ^ -(f & 1), axis=0) % (1 << eb))


def test_lowdim_payload_checks():
    d = torch.zeros((3, 4, 8), dtype=torch.uint8)
    w = torch.zeros((3, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="elem_bits"):
        dk.decode_delta_lowdim(d, w, 16)
    with pytest.raises(ValueError, match="lowdim payload"):
        dk.unpack_dims_lowdim(torch.zeros((3, 3, 16), dtype=torch.uint8),
                              torch.zeros((3, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="D \\* elem_sz"):
        pk.encode_lowdim(torch.zeros((24, 5), dtype=torch.uint8), 1)
    with pytest.raises(TypeError, match="int16"):
        pk.encode_lowdim(torch.zeros((24, 2), dtype=torch.uint8), 2)
    with pytest.raises(ValueError, match="multiple of 8"):
        pk.encode_lowdim(torch.zeros((20, 2), dtype=torch.int32), 1, errors=True)
