"""The FIRE kernels (``csrc/fire.cu``: the encode with and without its
per-block states, the serial decode and the chunked decode of a sidecar's
chunks) built on the host with g++ against a shim of CUDA's names
(``sprintz_tpu_torch/probes/host_build.py``: one std::thread a CUDA thread,
mbarriers as atomic words of arrivals and phase, shared memory and outputs
filled with garbage first, one and two CTAs at a time) and held to their
plain versions at ``host_build.FIRE_CASES``, bit-exact: chunk counts 1, 2,
7 and 33 of unequal lengths, 32 / D chunks a CTA at D <= 4, chunks across
CTAs of dims, rings that wrap, a chunk from random states. The plain
versions are held to the JAX package by ``test_torch_fire.py`` and
``test_torch_checkpoint_kernels.py``; on the card, ``chip_smoke.py`` holds
the kernels built with nvcc to them."""

import shutil

import pytest

from sprintz_tpu_torch.probes import host_build as hb


@pytest.fixture(scope="module")
def fire_library(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the kernels' host build needs it")
    return hb.build_fire(out=tmp_path_factory.mktemp("host"))


@pytest.mark.parametrize("resident", [1, 2])
@pytest.mark.parametrize("eb,ndims,nb,nchunks,trunc", hb.FIRE_CASES)
def test_host_built_fire_equals_plain(fire_library, resident, eb, ndims, nb,
                                      nchunks, trunc):
    hk = hb.HostKernels(fire_library, resident)
    assert hb.check_fire_case(hk, eb, ndims, nb, nchunks, trunc) is None
