"""The sidecar decode's two hand kernels in their chunked forms: the delta
decode with chunks (K1 ``unpack_zz`` and K2 ``prefix_finish``, and the
lowdim decode, with ``chunks=``: each chunk's state folded into their
look-backs) and FIRE's short-chunk decode (``fire_decode_short_kernel``),
built on the host with g++ against a shim of CUDA's names
(``sprintz_tpu_torch/probes/host_build.py``) and held to their plain
versions, bit-exact: the delta decode at ``unpack_cases.CHUNK_CASES``
(chunk starts mid-tile, several in one tile, at a tile's last block, empty
chunks, one chunk over many tiles and spans, long and short chunks side by
side, starts at the lowdim spans' edges, rows wider than a tile's shared
memory), FIRE at ``host_build.SHORT_CASES`` (ragged and empty chunks in
one warp, chunk images off 16 bytes, the widest and narrowest CTAs) on both
chunked kernels. Then the plain chunked decodes against the JAX package:
its delta arithmetic of ``_decode_pass_chunks`` (each chunk's
``delta_decode`` plus its state) at the same cases, and its
``fire_decode(init_state=)`` vmapped over chunks, with exact equality. On
the card, ``chip_smoke.py`` holds the kernels built with nvcc to the same
plain versions."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sprintz_tpu.models import forecasters as jf
from sprintz_tpu_torch.models import forecasters as fc
from sprintz_tpu_torch.ops import decode_kernels as dk
from sprintz_tpu_torch.probes import host_build as hb
from sprintz_tpu_torch.probes import unpack_cases as uc

from test_torch_checkpoint_kernels import jax_chunk_decoder

RESIDENT = 3
CPU = torch.device("cpu")

@pytest.fixture(scope="module")
def decode_library(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the kernels' host build needs it")
    return hb.HostKernels(hb.build(out=tmp_path_factory.mktemp("host")), RESIDENT)


@pytest.fixture(scope="module")
def fire_library(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the kernels' host build needs it")
    return hb.build_fire(out=tmp_path_factory.mktemp("host"))


@pytest.mark.parametrize("name,eb,ndims,nb,first", uc.CHUNK_CASES,
                         ids=[c[0] for c in uc.CHUNK_CASES])
def test_host_built_chunked_delta_decode_equals_plain(decode_library, name, eb,
                                                      ndims, nb, first):
    assert hb.check_chunk_case(decode_library, eb, ndims, nb, np.asarray(first),
                               nb + ndims) is None


@pytest.mark.parametrize("resident", [1, 2])
@pytest.mark.parametrize("eb,nd,nb,chunks,trunc", hb.SHORT_CASES)
def test_host_built_fire_chunk_kernels_equal_plain(fire_library, resident, eb, nd,
                                                   nb, chunks, trunc):
    hk = hb.HostKernels(fire_library, resident)
    zz, first, states = hb.short_case(eb, nd, nb, chunks, trunc)
    want = fc.fire_decode_chunks_plain(zz, eb, first, states, trunc)
    fits = fc.fire_short_fits(int(np.diff(first).max()), nd, eb)
    assert fits == (nd != 64 or eb != 8)  # the last case is the ring's alone
    for short in (True, False) if fits else (False,):
        got = hk.fire_decode_chunks(zz, eb, first, states, trunc, short)
        assert got.dtype == want.dtype and torch.equal(got, want), short


@pytest.mark.parametrize("name,eb,ndims,nb,first", uc.CHUNK_CASES,
                         ids=[c[0] for c in uc.CHUNK_CASES])
def test_plain_chunked_delta_decode_equals_jax(name, eb, ndims, nb, first):
    """K1 then K2 with chunks (and the lowdim decode with them, where D
    fits the layout), plain, against the JAX package's chunk arithmetic:
    each chunk's ``delta_decode`` plus its state, mod 2^eb."""
    rng = np.random.default_rng(nb + ndims)
    first = np.asarray(first, dtype=np.int64)
    states = rng.integers(-(1 << 20), 1 << 20, (first.size - 1, ndims)).astype(np.int32)
    ck = dk.delta_chunks(first, states, nb, ndims, CPU)
    dense, widths, fields = uc.unpack_case(rng, eb, ndims, nb, "random")
    got = [dk.decode_delta_contiguous(torch.from_numpy(dense), torch.from_numpy(widths),
                                      eb, ck)]
    if ndims * eb <= 32:
        ldense, lwidths, lfields = uc.lowdim_case(rng, eb, ndims, nb, "random")
        got.append(dk.decode_delta_lowdim(torch.from_numpy(ldense),
                                          torch.from_numpy(lwidths), eb, ck))
        all_fields = [fields, lfields]
    else:
        all_fields = [fields]
    for vals, f in zip(got, all_fields):
        zz = f.reshape(-1, ndims).astype(np.int32)
        for c in range(first.size - 1):
            r0, r1 = first[c] * 8, first[c + 1] * 8
            want = (jf.delta_decode(jnp.asarray(zz[r0:r1]), eb) + states[c][None, :]) & (
                (1 << eb) - 1)
            np.testing.assert_array_equal(dk.widen(vals).numpy()[r0:r1], np.asarray(want))


@pytest.mark.parametrize("eb,nd,nb,chunks,trunc",
                         [hb.SHORT_CASES[1], hb.SHORT_CASES[2],
                          hb.SHORT_CASES[6]])
def test_plain_chunked_fire_decode_equals_jax(eb, nd, nb, chunks, trunc):
    """The plain chunked FIRE decode at the short kernel's ragged, empty
    and misaligned chunks against the JAX package's ``fire_decode``
    vmapped over the chunks (each padded with zero errors to the
    longest, as ``_decode_pass_chunks`` pads them)."""
    zz, first, states = hb.short_case(eb, nd, nb, chunks, trunc)
    got = dk.widen(fc.fire_decode_chunks(zz, eb, first, states, trunc)).numpy()
    lens = np.diff(first)
    c = lens.size
    pad = np.zeros((c, max(int(lens.max()), 1) * 8, nd), np.int32)
    errs = zz.to(torch.int32).numpy()
    for k in range(c):
        pad[k, : lens[k] * 8] = errs[first[k] * 8: first[k + 1] * 8]
    want = np.asarray(jax_chunk_decoder(eb, trunc)(jnp.asarray(pad),
                                                   jnp.asarray(states.numpy())))
    want = np.concatenate([want[k, : lens[k] * 8] for k in range(c)])
    np.testing.assert_array_equal(got, want)
