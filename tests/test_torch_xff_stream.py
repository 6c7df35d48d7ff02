"""The PyTorch port's FIRE (xff) compress and decompress, on the CPU (the
kernels' plain versions), against the JAX package and the golden codec:
the same bytes out of compress, each package decodes the other's streams,
and the reference-made xff vectors decode and re-encode exactly."""

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
from test_torch_stream import runs_stream

VECTORS = pathlib.Path(__file__).resolve().parent / "vectors"


def xff_roundtrip(x: np.ndarray, ndims: int) -> bytes:
    """Port bytes == JAX bytes == golden bytes; both packages decode them
    to x."""
    es = x.dtype.itemsize
    got = encoder.compress(x, ndims, codec="xff", device="cpu")
    assert got == jenc.compress(x, ndims, codec="xff"), "port != JAX"
    assert got == compress_rowmajor_rle(x, ndims, codec="xff"), "port != golden"
    np.testing.assert_array_equal(
        decoder.decompress(got, codec="xff", elem_sz=es, device="cpu"), x)
    np.testing.assert_array_equal(
        jdec.decompress(got, codec="xff", elem_sz=es), x)
    return got


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("elem_sz,ndims", [(1, 5), (1, 16), (1, 64), (2, 3),
                                           (2, 8), (2, 17)])
def test_xff_compress_matches_jax_and_golden(rng, elem_sz, ndims, kind):
    # 101 rows: six whole groups, a block left over for the verbatim tail,
    # and five more rows; plus 3 elements that end mid-row
    xff_roundtrip(make_stream(rng, 101 * ndims + 3, elem_sz, kind), ndims)


@pytest.mark.parametrize("elem_sz,ndims,seg", [(1, 64, 24), (2, 8, 40),
                                               (1, 5, 16)])
def test_xff_runs_cross_decode(rng, elem_sz, ndims, seg):
    """Constant segments are FIRE zero runs once the forecaster has
    settled on a zero delta; run blocks decode as zero errors."""
    x = runs_stream(rng, 1200, ndims, elem_sz, seg)
    got = xff_roundtrip(x, ndims)
    ngroups, _, _ = read_metadata_rle(got)
    idx = decoder.walk_headers(got, ngroups, ndims, elem_sz)
    assert idx.total_rows > idx.widths.shape[0] * 8  # the stream has runs


def test_xff_run_to_the_last_group(rng):
    """A zero run that reaches the last full group's start: FIRE's run
    comparator allows equality where delta's does not."""
    ndims = 6
    x = np.zeros((8 * 41 + 3, ndims), np.uint8)
    x[:8] = rng.integers(0, 256, (8, ndims))
    x[8:] = x[7]
    flat = x.reshape(-1)
    assert xff_roundtrip(flat, ndims) != compress_rowmajor_rle(
        flat, ndims, codec="delta")


@pytest.mark.parametrize("name,ndims,elem_sz", [
    ("xff_8b_d16_sparse", 16, 1), ("xff_16b_d8_rand", 8, 2)])
def test_xff_reference_vectors(name, ndims, elem_sz):
    ref = (VECTORS / f"{name}.sprintz").read_bytes()
    want = np.frombuffer((VECTORS / f"{name}.in").read_bytes(),
                         np.uint8 if elem_sz == 1 else np.uint16)
    codec = sprintz_tpu_torch.SprintzCodec("xff", elem_sz, device="cpu")
    np.testing.assert_array_equal(codec.decompress(ref), want)
    assert codec.compress(want, ndims=ndims) == ref


def test_xff_lowdim_matches_jax():
    """Lowdim xff (full-precision coefficients) through the public entry
    points: the port's bytes are the JAX package's, and each package
    decodes the other's stream."""
    x = np.arange(400, dtype=np.uint8).reshape(-1, 4)
    want = jenc.compress(x.reshape(-1), 4, codec="xff")
    got = sprintz_tpu_torch.compress(x, codec="xff", device="cpu")
    assert got == want
    np.testing.assert_array_equal(sprintz_tpu_torch.decompress(
        want, codec="xff", device="cpu"), x.reshape(-1))
    np.testing.assert_array_equal(
        jdec.decompress(got, codec="xff", elem_sz=1), x.reshape(-1))
