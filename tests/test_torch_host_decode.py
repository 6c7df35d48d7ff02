"""The delta decode's CUDA kernels (``csrc/decode.cu``: K1/K4/K5, K2 and the
lowdim decode, serial and in chunks) built on the host with g++ against a
shim of CUDA's names (``sprintz_tpu_torch/probes/host_build.py``: one
std::thread a CUDA thread, three CTAs at a time so that a look-back waits
on tiles or spans beside it, shared memory and outputs filled with garbage
first) and held to their plain versions at ``probes/unpack_cases.py``'s
cases (``UNPACK_CASES``; ``LOWDIM_CASES`` for both modes of the lowdim
decode, whose status words must come back zeroed; ``SEED_CASES`` for the
chunked decode, K1 then K2 and the lowdim decode with chunks, from states
that move nothing and from moved ones, also against the serial decode
followed by the plain chunk seed), bit-exact. The plain
versions are held to the JAX package at the same cases by
``test_torch_unpack_shapes.py``, ``test_torch_lowdim_pack.py`` and
``test_torch_lowdim_pass.py``; on the card, ``chip_smoke.py`` holds the
kernels built with nvcc to them."""

import shutil

import pytest

from sprintz_tpu_torch.probes import host_build as hb
from sprintz_tpu_torch.probes import unpack_cases as uc

RESIDENT = 3


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the kernels' host build needs it")
    return hb.HostKernels(hb.build(out=tmp_path_factory.mktemp("host")), RESIDENT)


@pytest.mark.parametrize("eb,ndims,nb,kind", uc.UNPACK_CASES)
def test_host_built_kernels_equal_plain(host_kernels, eb, ndims, nb, kind):
    assert hb.check_case(host_kernels, eb, ndims, nb, kind) is None


@pytest.mark.parametrize("eb,ndims,nb,kind", uc.LOWDIM_CASES)
def test_host_built_lowdim_unpack_equals_plain(host_kernels, eb, ndims, nb, kind):
    assert hb.check_lowdim_case(host_kernels, eb, ndims, nb, kind) is None


@pytest.mark.parametrize("eb,ndims,nb,nchunks", uc.SEED_CASES)
def test_host_built_chunk_seed_equals_plain(host_kernels, eb, ndims, nb,
                                            nchunks):
    assert hb.check_seed_case(host_kernels, eb, ndims, nb, nchunks) is None
