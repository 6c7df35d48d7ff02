"""The query pushdown's reduce kernels: ``ops/query_kernels.reduce_cols``'s
plain version against numpy, exactly (integers: the tolerance is zero);
``csrc/query.cu`` built with g++ on the host
(``sprintz_tpu_torch/probes/host_build.py``: one std::thread a CUDA thread,
the output and shared memory filled with garbage first, 1 and 3 CTAs at a
time) against the plain version at ``host_build.QUERY_CASES``; and the
reduce as the epilogue of K2 and of the lowdim decode (``csrc/decode.cu``'s
REDUCE instantiations, host-built) against theirs at
``host_build.EPILOGUE_CASES``, the kept accumulators (and the lowdim
decode's status words) zero again after every launch. On the card,
``chip_smoke.py`` holds the kernels built with nvcc to the plain
versions."""

import shutil

import numpy as np
import pytest
import torch

from sprintz_tpu_torch.ops import decode_kernels as dk
from sprintz_tpu_torch.ops import query_kernels as qk
from sprintz_tpu_torch.probes import host_build as hb


def _numpy_reduce(x: np.ndarray, op: str, gaps=None, lead=False):
    """numpy's answer: int64 sums wrapped to int32, max, min."""
    v = x.astype(np.int64)
    if op == "sum":
        if gaps is not None:
            w = np.ones(len(v), np.int64)
            w[7::8] += gaps
            v = v * w[:, None]
        s = v.sum(axis=0) & 0xFFFFFFFF
        return (s - ((s & 0x80000000) << 1)).astype(np.int32)
    if op == "max":
        return v.max(axis=0).astype(np.int32)
    m = v.min(axis=0)
    return (np.minimum(m, 0) if lead else m).astype(np.int32)


@pytest.mark.parametrize("op", qk.OPS)
@pytest.mark.parametrize("eb,ndims,rows", [(8, 1, 9), (8, 5, 808),
                                           (8, 64, 1000), (16, 2, 520),
                                           (16, 3, 40000)])
def test_reduce_plain_equals_numpy(op, eb, ndims, rows):
    rng = np.random.default_rng(eb + ndims + rows)
    top = 1 << eb
    x = rng.integers(top - top // 32, top, (rows, ndims))
    x[rng.integers(0, rows, 4), rng.integers(0, ndims, 4)] = 0
    vals = dk.narrow(torch.from_numpy(x.astype(np.int32)), eb)
    got = qk.reduce_cols(vals, op)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _numpy_reduce(x, op))
    if rows % 8 == 0:
        gaps = rng.integers(0, 1 << 24, rows // 8).astype(np.int32)
        np.testing.assert_array_equal(
            qk.reduce_cols(vals, op, gaps, leading_gap=True).numpy(),
            _numpy_reduce(x, op, gaps if op == "sum" else None, lead=True))


def test_reduce_wraps_past_2_31():
    """The u16 sum of 40000 rows near 65535 passes 2^31: the result is the
    int32 that wraps, not the int64 sum."""
    x = np.full((40000, 3), 65000, np.int32)
    got = qk.reduce_cols(dk.narrow(torch.from_numpy(x), 16), "sum").numpy()
    assert int(x[:, 0].astype(np.int64).sum()) > 1 << 31
    np.testing.assert_array_equal(got, _numpy_reduce(x, "sum"))
    assert (got < 0).all()


def test_reduce_empty_and_refusals():
    vals = torch.zeros((0, 4), dtype=torch.uint8)
    assert qk.reduce_cols(vals, "sum").tolist() == [0] * 4
    assert qk.reduce_cols(vals, "max").tolist() == [0] * 4
    assert qk.reduce_cols(vals, "min").tolist() == [qk.MIN_EMPTY] * 4
    assert qk.reduce_cols(vals, "min", leading_gap=True).tolist() == [0] * 4
    with pytest.raises(ValueError, match="op"):
        qk.reduce_cols(vals, "mean")
    with pytest.raises(TypeError):
        qk.reduce_cols(torch.zeros((8, 4), dtype=torch.int32), "sum")
    with pytest.raises(ValueError, match="whole blocks"):
        qk.reduce_cols(torch.zeros((9, 4), dtype=torch.uint8), "sum",
                       np.zeros(1, np.int32))
    with pytest.raises(ValueError, match="gap_after"):
        qk.reduce_cols(torch.zeros((16, 4), dtype=torch.uint8), "sum",
                       np.zeros(3, np.int32))


@pytest.fixture(scope="module")
def query_library(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the kernel's host build needs it")
    return hb.build_query(out=tmp_path_factory.mktemp("host"))


@pytest.mark.parametrize("resident", [1, 3])
@pytest.mark.parametrize("eb,ndims,rows", hb.QUERY_CASES)
def test_host_built_reduce_equals_plain(query_library, resident, eb, ndims,
                                        rows):
    hk = hb.HostKernels(query_library, resident)
    assert hb.check_query_case(hk, eb, ndims, rows) is None


@pytest.fixture(scope="module")
def decode_library(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the kernels' host build needs it")
    return hb.build(out=tmp_path_factory.mktemp("host"))


@pytest.mark.parametrize("resident", [1, 3])
@pytest.mark.parametrize("eb,ndims,nb,values", hb.EPILOGUE_CASES)
def test_host_built_epilogue_equals_plain(decode_library, resident, eb, ndims,
                                          nb, values):
    hk = hb.HostKernels(decode_library, resident)
    assert hb.check_epilogue_case(hk, eb, ndims, nb, values) is None


def test_epilogue_refusals():
    """The epilogue wrappers' argument checks (on the CPU, before the plain
    version)."""
    bz = torch.zeros((16, 4), dtype=torch.uint8)
    toff = torch.zeros((1, 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="op"):
        qk.prefix_finish_reduce(bz, toff, 8, "mean")
    with pytest.raises(ValueError, match="tile_offsets"):
        qk.prefix_finish_reduce(bz, toff[:, :, :3], 8, "sum")
    with pytest.raises(ValueError, match="gap_after"):
        qk.prefix_finish_reduce(bz, toff, 8, "sum", np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="whole blocks"):
        qk.prefix_finish_reduce(bz[:9], toff, 8, "sum", np.zeros(1, np.int32))
    dense = torch.zeros((2, 4, 8), dtype=torch.uint8)
    widths = torch.zeros((2, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="elem_bits"):
        qk.decode_lowdim_reduce(dense, widths, 16, "sum")
    vals, red = qk.decode_reduce(dense, widths, 8, "min", store=False,
                                 lowdim=True, leading_gap=True)
    assert vals is None and red.tolist() == [0] * 4
