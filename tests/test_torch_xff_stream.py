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
from sprintz_tpu.golden.lowdim import decompress_lowdim_rle
from sprintz_tpu.golden.rowmajor import (compress_rowmajor_rle,
                                         decompress_rowmajor_rle)
import sprintz_tpu_torch
from sprintz_tpu_torch import decoder, encoder
from sprintz_tpu_torch.constants import LOWDIM_MAX_NDIMS, METADATA_LEN_RLE
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


def walk_stream(rng, rows: int, ndims: int, elem_sz: int) -> np.ndarray:
    steps = rng.integers(-6, 7, (rows, ndims))
    walk = np.cumsum(steps, axis=0) % (1 << (8 * elem_sz))
    return walk.astype(np.uint8 if elem_sz == 1 else np.uint16).reshape(-1)


def run_edges(buf: bytes, plan: list[int], ndims: int, elem_sz: int,
              lowdim: bool) -> int:
    """The segment edges with a run block on either side."""
    start, edges = METADATA_LEN_RLE, 0
    for k, groups in enumerate(plan):
        idx = decoder.walk_headers(buf, groups, ndims, elem_sz, lowdim, start)
        start = idx.tail_offset
        first = idx.out_rows[0] if idx.out_rows.size else idx.total_rows
        last = idx.out_rows[-1] + 8 if idx.out_rows.size else 0
        edges += (k > 0 and first > 0) + (k < len(plan) - 1
                                          and last < idx.total_rows)
    return edges


@pytest.mark.parametrize("elem_sz,ndims,codec,rows,extra,seg,consts", [
    pytest.param(1, 1, "xff", 16 * 48, 0, 0, (1, 8, 6), id="u8-lowdim-d1"),
    pytest.param(2, 3, "xff", 16 * 48, 0, 0, (1, 8, 6),
                 id="u16-rowmajor-d3"),
    pytest.param(1, 4, "xff", 16 * 48, 0, 24, (1, 4, 9),
                 id="run-at-a-segment-edge"),
    pytest.param(2, 2, "xff", 16 * 20, 0, 0, (1, 1, 12),
                 id="last-segment-of-one-group"),
    pytest.param(1, 5, "xff", 16 * 40 + 9, 3, 0, (1, 8, 6),
                 id="verbatim-tail"),
    pytest.param(1, 1, "xff", 16 * 40, 0, 0, (1, 21, 6),
                 id="under-the-threshold"),
    pytest.param(2, 3, "xff", 16 * 48, 0, 0, (1 << 20, 1, 6),
                 id="under-the-bytes"),
    pytest.param(2, 3, "delta", 16 * 48, 0, 0, (1, 8, 6), id="delta"),
])
def test_segmented_decode(rng, monkeypatch, elem_sz, ndims, codec, rows,
                          extra, seg, consts):
    """``decompress`` in segments, its constants lowered so that small
    streams split: the values of the one-segment decode, of the golden
    codec and of the input, FIRE's chain carried across every edge;
    delta streams and xff streams under either threshold take one
    segment."""
    x = (runs_stream(rng, rows, ndims, elem_sz, seg) if seg
         else walk_stream(rng, rows, ndims, elem_sz))
    x = np.concatenate([x, x[:extra]])
    lowdim = ndims <= LOWDIM_MAX_NDIMS[elem_sz]
    buf = encoder.compress(x, ndims, codec=codec, device="cpu")
    one = decoder.decompress(buf, codec=codec, elem_sz=elem_sz, device="cpu")
    golden = (decompress_lowdim_rle if lowdim else decompress_rowmajor_rle)(
        buf, codec=codec, elem_sz=elem_sz)
    for name, value in zip(("PIPE_BYTES", "PIPE_GROUPS", "PIPE_SEGMENTS"),
                           consts):
        monkeypatch.setattr(decoder, name, value)
    ngroups, remaining, _ = read_metadata_rle(buf)
    plan = decoder.segment_plan(codec, ngroups, len(buf))
    before = decoder.decompress.segments
    got = decoder.decompress(buf, codec=codec, elem_sz=elem_sz, device="cpu")
    assert decoder.decompress.segments - before == len(plan)
    np.testing.assert_array_equal(got, one)
    np.testing.assert_array_equal(got, golden)
    np.testing.assert_array_equal(got, x)
    if (codec == "delta" or len(buf) < 2 * consts[0]
            or ngroups < 2 * consts[1]):
        assert plan == [ngroups]
        return
    assert len(plan) > 1 and sum(plan) == ngroups
    if seg:
        assert run_edges(buf, plan, ndims, elem_sz, lowdim) > 0
    if extra:
        assert remaining > ndims
    if consts[1] == 1:
        assert plan[-1] == 1
