"""The encode side's edge shapes (``sprintz_tpu_torch/probes/encode_cases``)
on the CPU: the plain versions of K3 ``pack_rows`` and of the Huffman
encoder against the JAX package, bit-exact. ``chip_smoke.py`` holds the
kernels to these plain versions at the same shapes on the card.

K3 at D 5..1024, u8 and u16, over three of its tiles (all-zero widths,
all-maximum widths, a ragged last tile) against ``pack_rows_rowmajor``
and, up to D 129, ``pack_rows_pallas(interpret=True)``: the Pallas
kernel traces a step an output byte, 100-320 s at D 1024 on a CPU. The
encoder at chunk sizes 1, 31, 128 and 4096 against ``_huff_compress_host``
and ``huff_compress_device``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sprintz_tpu.entropy.huffman as jhf
from sprintz_tpu.ops.pack import pack_rows_rowmajor
from sprintz_tpu.ops.pallas_pack import pack_rows_pallas
from sprintz_tpu_torch.entropy import huffman as hf
from sprintz_tpu_torch.ops import huffman_kernels as hk
from sprintz_tpu_torch.ops import pack_kernels as pk
from sprintz_tpu_torch.probes import encode_cases as ec

PALLAS_MAX_DIMS = 129


@pytest.mark.parametrize("ndims,elem_sz", ec.PACK_CASES)
def test_pack_rows_edge_shapes(rng, ndims, elem_sz):
    errs, widths = ec.pack_case(rng, ndims, elem_sz)
    got = pk.pack_rows(torch.from_numpy(errs), torch.from_numpy(widths),
                       elem_sz).numpy()
    e, w = jnp.asarray(errs), jnp.asarray(widths)
    np.testing.assert_array_equal(
        got, np.asarray(pack_rows_rowmajor(e, w, elem_sz)))
    if ndims <= PALLAS_MAX_DIMS:
        np.testing.assert_array_equal(
            got, np.asarray(pack_rows_pallas(e, w, elem_sz, interpret=True)))
    tb = max(1, pk.pack_tile_rows(ndims, elem_sz) // 8)
    assert errs.shape[0] % tb or tb == 1  # a ragged last tile
    assert not got[:tb].any()  # all-zero widths: an all-zero tile


@pytest.mark.parametrize("cs,kind", ec.HUFF_CASES)
def test_encode_chunks_edge_shapes(rng, cs, kind):
    data, table = ec.huff_case(rng, cs, kind)
    t = hf.build_table(data) if table is None else table
    payload, sizes = hk.encode_chunks(torch.from_numpy(data),
                                      *hf.encode_table(t, "cpu"), cs)
    want = jhf._huff_compress_host(data, cs, t)
    assert want == jhf.huff_compress_device(data, cs, t)
    _, _, nchunks, _, jsizes, offsets = jhf._parse(want)
    np.testing.assert_array_equal(sizes.numpy(), jsizes)
    assert payload.numpy().tobytes() == want[int(offsets[0]):]
    if kind == "short":
        assert nchunks == 1
    if kind == "12-bit codes":
        assert set(t.lengths[np.unique(data)]) == {12}
    if kind == "ragged":
        assert data.size % cs or cs == 1
