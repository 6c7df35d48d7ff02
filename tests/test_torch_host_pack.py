"""The encode kernels (``csrc/pack.cu``: K3 ``pack_rows_kernel`` and the
lowdim ``encode_lowdim_kernel``, from the rows and from FIRE's errors)
built on the host with g++ against the shim of CUDA's names that
``test_torch_host_decode.py`` uses (``sprintz_tpu_torch/probes/host_build.py``,
``host_shim.h``: one std::thread a CUDA thread, three CTAs at a time,
shared memory and outputs filled with garbage first) and held to their
plain versions at ``probes/encode_cases.py``'s ``PACK_CASES`` and
``LOWDIM_PACK_CASES``, bit-exact. ``test_torch_encode_shapes.py``,
``test_torch_lowdim_pack.py`` and ``test_torch_lowdim_pass.py`` hold the
plain versions to the JAX package."""

import shutil

import pytest

from sprintz_tpu_torch.probes import encode_cases as ec
from sprintz_tpu_torch.probes import host_build as hb

RESIDENT = 3


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the kernels' host build needs it")
    return hb.HostKernels(hb.build_pack(out=tmp_path_factory.mktemp("host")),
                          RESIDENT)


@pytest.mark.parametrize("ndims,elem_sz,nb", ec.LOWDIM_PACK_CASES)
def test_host_built_lowdim_pack_equals_plain(host_kernels, ndims, elem_sz, nb):
    assert hb.check_pack_case(host_kernels, ndims, elem_sz, nb) is None


@pytest.mark.parametrize("ndims,elem_sz", ec.PACK_CASES)
def test_host_built_pack_rows_equals_plain(host_kernels, ndims, elem_sz):
    assert hb.check_pack_case(host_kernels, ndims, elem_sz) is None
