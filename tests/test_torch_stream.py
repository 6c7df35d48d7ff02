"""The PyTorch port's compress and decompress, on the CPU (the kernels'
plain versions), against the JAX package and the golden codec: the same
bytes out of compress, and each package decodes the other's streams."""

import pathlib

import numpy as np
import pytest

from conftest import KINDS, make_stream
from sprintz_tpu import decoder as jdec
from sprintz_tpu import encoder as jenc
from sprintz_tpu.golden.rowmajor import compress_rowmajor_rle
import sprintz_tpu_torch
from sprintz_tpu_torch import decoder, encoder
from sprintz_tpu_torch.stream_format import read_metadata_rle

VECTORS = pathlib.Path(__file__).resolve().parent / "vectors"
GRID = [(1, 5), (1, 9), (1, 64), (1, 129), (2, 3), (2, 17), (2, 64)]


def port_roundtrip(x: np.ndarray, ndims: int) -> bytes:
    """Port bytes == JAX bytes; both packages decode them to x."""
    es = x.dtype.itemsize
    got = encoder.compress(x, ndims, device="cpu")
    assert got == jenc.compress(x, ndims), "port bytes != JAX bytes"
    np.testing.assert_array_equal(
        decoder.decompress(got, elem_sz=es, device="cpu"), x)
    np.testing.assert_array_equal(jdec.decompress(got, elem_sz=es), x)
    return got


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("elem_sz,ndims", GRID)
def test_compress_matches_jax_and_golden(rng, elem_sz, ndims, kind):
    # 101 rows: six whole groups, a block left over for the verbatim tail,
    # and five more rows; plus 3 elements that end mid-row
    x = make_stream(rng, 101 * ndims + 3, elem_sz, kind)
    got = port_roundtrip(x, ndims)
    assert got == compress_rowmajor_rle(x, ndims, codec="delta")


@pytest.mark.parametrize("elem_sz,ndims", [(1, 5), (1, 64), (2, 3)])
def test_short_streams(rng, elem_sz, ndims):
    """Below MIN_DATA_SIZE the stream is verbatim; above it but short of a
    group it is all tail."""
    for n in (0, 1, 127, 128, 16 * ndims - 1, 16 * ndims, 16 * ndims + 1):
        x = make_stream(rng, n, elem_sz, "rand")
        got = port_roundtrip(x, ndims)
        assert got == compress_rowmajor_rle(x, ndims, codec="delta"), n


def runs_stream(rng, nrows, ndims, elem_sz, seg=256):
    """bench.py's runs family: every third seg-row segment is constant."""
    steps = rng.integers(-6, 7, (nrows, ndims))
    flat = (np.arange(nrows) // seg % 3 == 0)[:, None]
    walk = np.cumsum(np.where(flat, 0, steps), axis=0) % (1 << (8 * elem_sz))
    return walk.astype(np.uint8 if elem_sz == 1 else np.uint16).reshape(-1)


@pytest.mark.parametrize("elem_sz,ndims,seg", [(1, 64, 256), (2, 17, 40),
                                               (1, 9, 24)])
def test_runs_streams_cross_decode(rng, elem_sz, ndims, seg):
    x = runs_stream(rng, 3000, ndims, elem_sz, seg)
    got = port_roundtrip(x, ndims)
    ngroups, _, _ = read_metadata_rle(got)
    idx = decoder.walk_headers(got, ngroups, ndims, elem_sz)
    assert idx.total_rows > idx.widths.shape[0] * 8  # the stream has runs
    assert got == compress_rowmajor_rle(x, ndims, codec="delta")


def test_run_past_the_cap(rng):
    """70 000 zero blocks: the run passes the 0x7FFF cap twice."""
    ndims = 5
    x = np.zeros((70_004 * 8, ndims), np.uint8)
    x[:16] = rng.integers(0, 256, (16, ndims))
    x[-9:] = rng.integers(0, 256, (9, ndims))
    port_roundtrip(x.reshape(-1), ndims)


def test_port_decodes_jax_streams_with_runs(rng):
    x = make_stream(rng, 40_000, 1, "sparse")
    buf = jenc.compress(x, 10)
    np.testing.assert_array_equal(
        sprintz_tpu_torch.decompress(buf, device="cpu"), x)
    assert sprintz_tpu_torch.compress(x.reshape(-1, 10), device="cpu") == buf


@pytest.mark.parametrize("name,ndims,elem_sz", [
    ("delta_8b_d9_rand", 9, 1), ("delta_16b_d17_sparse", 17, 2)])
def test_reference_vectors(name, ndims, elem_sz):
    ref = (VECTORS / f"{name}.sprintz").read_bytes()
    want = np.frombuffer((VECTORS / f"{name}.in").read_bytes(),
                         np.uint8 if elem_sz == 1 else np.uint16)
    codec = sprintz_tpu_torch.SprintzCodec(elem_sz=elem_sz, device="cpu")
    np.testing.assert_array_equal(codec.decompress(ref), want)
    assert codec.compress(want, ndims=ndims) == ref
    assert codec.compress(want.reshape(-1, ndims)) == ref


def test_truncated_streams_raise(rng):
    x = make_stream(rng, 64 * 40, 1, "rand")
    buf = sprintz_tpu_torch.compress(x.reshape(-1, 64), device="cpu")
    for cut in (3, 20, len(buf) // 2, len(buf) - 1):
        with pytest.raises(sprintz_tpu_torch.CorruptStreamError):
            sprintz_tpu_torch.decompress(buf[:cut], device="cpu")
