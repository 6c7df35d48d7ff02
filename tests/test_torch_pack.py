"""Pack kernels of the PyTorch port (K3 pack_rows, K4 unpack_rows) against
the JAX package's Pallas kernels (interpret mode) and its XLA versions in
ops/pack.py. On a CPU tensor each wrapper runs its plain PyTorch version;
every comparison is bit-exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sprintz_tpu.ops.pack import pack_rows_rowmajor, unpack_rows_rowmajor
from sprintz_tpu.ops.pallas_pack import pack_rows_pallas, unpack_rows_pallas
from sprintz_tpu_torch.ops import pack_kernels as pk
from test_torch_kernels import edge_widths, payload


@pytest.mark.parametrize("elem_sz,ndims,nb", [(1, 9, 64), (2, 17, 32)])
def test_pack_rows_matches_pallas_and_xla(rng, elem_sz, ndims, nb):
    eb = 8 * elem_sz
    widths = edge_widths(rng, nb, ndims, eb)
    fields, dense = payload(rng, widths, eb)
    errs = jnp.asarray(fields, jnp.int32)
    w = jnp.asarray(widths, jnp.int32)
    got = pk.pack_rows(torch.from_numpy(fields.astype(np.int32)),
                       torch.from_numpy(widths.astype(np.int32)), elem_sz)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), dense)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(pack_rows_pallas(errs, w, elem_sz,
                                                 interpret=True)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(pack_rows_rowmajor(errs, w, elem_sz)))


@pytest.mark.parametrize("elem_sz,ndims,nb", [(1, 9, 64), (2, 17, 32)])
def test_unpack_rows_matches_pallas_and_xla(rng, elem_sz, ndims, nb):
    eb = 8 * elem_sz
    widths = edge_widths(rng, nb, ndims, eb)
    fields, dense = payload(rng, widths, eb)
    got = pk.unpack_rows(torch.from_numpy(dense),
                         torch.from_numpy(widths.astype(np.uint8)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), fields)
    d32 = jnp.asarray(dense, jnp.int32)
    w = jnp.asarray(widths, jnp.int32)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(unpack_rows_pallas(d32, w, interpret=True)))
    # unpack_rows_rowmajor defaults to elem_sz=2: pass the stream's own
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(unpack_rows_rowmajor(d32, w,
                                                     elem_sz=elem_sz)))


def test_u16_fields_need_a_three_byte_window(rng):
    """A 16-bit field at bit offset 7 spans bits 7..22: three bytes. A
    two-byte window would drop its top 7 bits."""
    widths = np.array([[7 - 4, 4, 16, 16]])  # offsets 0, 3, 7, 23
    fields = np.zeros((1, 8, 4), np.int64)
    fields[0, :, 2] = 0xFFFF
    fields[0, :, 3] = 0x8001
    dense = pk.pack_rows(torch.from_numpy(fields.astype(np.int32)),
                         torch.from_numpy(widths.astype(np.int32)), 2)
    row = int.from_bytes(dense[0, 0].numpy().tobytes(), "little")
    assert row == (0xFFFF << 7) | (0x8001 << 23)
    back = pk.unpack_rows(dense, torch.from_numpy(widths.astype(np.uint8)))
    np.testing.assert_array_equal(back.numpy(), fields)


def test_pack_rows_zero_fills_past_the_fields(rng):
    widths = np.full((3, 5), 3)  # 15 bits: 2 bytes of 5
    fields = rng.integers(0, 8, (3, 8, 5))
    dense = pk.pack_rows(torch.from_numpy(fields.astype(np.int32)),
                         torch.from_numpy(widths.astype(np.int32)), 1)
    assert dense.shape == (3, 8, 5)
    assert not dense[:, :, 2:].any()


def test_pack_wrappers_check_their_inputs():
    errs = torch.zeros((4, 8, 6), dtype=torch.int32)
    widths = torch.zeros((4, 6), dtype=torch.int32)
    with pytest.raises(ValueError):
        pk.pack_rows(errs, widths, 3)
    with pytest.raises(TypeError):
        pk.pack_rows(errs.to(torch.int64), widths, 1)
    with pytest.raises(ValueError):
        pk.pack_rows(errs[:, :4], widths, 1)
    with pytest.raises(ValueError):
        pk.unpack_rows(torch.zeros((4, 8, 0), dtype=torch.uint8),
                       widths.to(torch.uint8))
