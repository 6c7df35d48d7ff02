"""The PyTorch port's lowdim layout (u8 ndims <= 4, u16 ndims <= 2) on the
CPU (the kernels' plain versions) against the JAX package and the golden
lowdim codec: delta and FIRE (xff, full-precision coefficient), the same
bytes out of compress, each package decodes the other's streams, the
reference-made lowdim vectors decode and re-encode exactly, the layout's
boundary, and +Huf on top. Every comparison is bit-exact."""

import pathlib

import numpy as np
import pytest
import torch

from sprintz_tpu import api as japi
from sprintz_tpu import decoder as jdec
from sprintz_tpu import encoder as jenc
from sprintz_tpu.entropy import huffman as jhf
from sprintz_tpu.golden.lowdim import compress_lowdim_rle
from sprintz_tpu.golden.rowmajor import compress_rowmajor_rle
import sprintz_tpu_torch
from sprintz_tpu_torch import decoder, encoder, planner
from sprintz_tpu_torch.entropy import huffman as hf
from sprintz_tpu_torch.stream_format import read_metadata_rle

VECTORS = pathlib.Path(__file__).resolve().parent / "vectors"
LOWDIM = [(1, 1), (1, 2), (1, 3), (1, 4), (2, 1), (2, 2)]
KINDS = ["walk", "rand", "const", "zero prefix", "runs"]


def lowdim_stream(rng, kind: str, nrows: int, ndims: int,
                  elem_sz: int) -> np.ndarray:
    """(nrows, ndims) u8/u16 rows of one family."""
    hi = 1 << (8 * elem_sz)
    if kind == "walk":
        x = np.cumsum(rng.integers(-6, 7, (nrows, ndims)), axis=0)
    elif kind == "rand":
        x = rng.integers(0, hi, (nrows, ndims))
    elif kind == "const":
        x = np.broadcast_to(rng.integers(0, hi, ndims), (nrows, ndims))
    elif kind == "zero prefix":  # runs from the start, then a walk
        x = np.cumsum(rng.integers(-6, 7, (nrows, ndims)), axis=0)
        x[: nrows // 2] = 0
        x[nrows // 2:] -= x[nrows // 2]
    elif kind == "runs":  # every third 24-row segment constant
        steps = rng.integers(-6, 7, (nrows, ndims))
        flat = (np.arange(nrows) // 24 % 3 == 0)[:, None]
        x = np.cumsum(np.where(flat, 0, steps), axis=0)
    else:
        raise ValueError(kind)
    return (x % hi).astype(np.uint8 if elem_sz == 1 else np.uint16)


def lowdim_roundtrip(x: np.ndarray, ndims: int, codec: str) -> bytes:
    """Port bytes == JAX bytes == golden bytes; both packages decode them
    to x."""
    x = x.reshape(-1)
    es = x.dtype.itemsize
    got = encoder.compress(x, ndims, codec=codec, device="cpu")
    assert got == jenc.compress(x, ndims, codec=codec), "port != JAX"
    assert got == compress_lowdim_rle(x, ndims, codec=codec), "port != golden"
    np.testing.assert_array_equal(
        decoder.decompress(got, codec=codec, elem_sz=es, device="cpu"), x)
    np.testing.assert_array_equal(
        jdec.decompress(got, codec=codec, elem_sz=es), x)
    return got


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("elem_sz,ndims", LOWDIM)
@pytest.mark.parametrize("codec", ["delta", "xff"])
def test_lowdim_compress_matches_jax_and_golden(rng, codec, elem_sz, ndims,
                                                kind):
    # 203 rows: 12 whole groups, a block for the verbatim tail and 3 rows;
    # plus one element that ends mid-row (where D > 1)
    x = lowdim_stream(rng, kind, 203, ndims, elem_sz).reshape(-1)
    got = lowdim_roundtrip(np.concatenate([x, x[:1]]), ndims, codec)
    if kind in ("const", "zero prefix", "runs"):
        ngroups, _, _ = read_metadata_rle(got)
        idx = decoder.walk_headers(got, ngroups, ndims, elem_sz, lowdim=True)
        assert idx.total_rows > idx.widths.shape[0] * 8  # the stream has runs


@pytest.mark.parametrize("elem_sz,ndims,codec", [(1, 1, "delta"),
                                                 (1, 3, "xff"),
                                                 (2, 2, "delta")])
def test_lowdim_short_streams(rng, elem_sz, ndims, codec):
    """Below MIN_DATA_SIZE the stream is verbatim; a length that is no
    multiple of D; one element short of a group, a group, and one past."""
    group = 16 * ndims
    for n in (0, 1, 127, 128, 129, 9 * group - 1, 9 * group, 9 * group + 1):
        x = lowdim_stream(rng, "walk", n // ndims + 1, ndims, elem_sz)
        lowdim_roundtrip(x.reshape(-1)[:n], ndims, codec)


def test_lowdim_xff_run_to_the_last_group(rng):
    """A zero run that reaches the last full group's start: lowdim FIRE
    keeps delta's strict comparator, where the row-major layout's allows
    equality (the JAX package's encoder.py:346)."""
    ndims = 3
    # whole blocks, so that the run can end exactly at that start
    x = np.zeros((8 * 41, ndims), np.uint8)
    x[:8] = rng.integers(0, 256, (8, ndims))
    x[8:] = x[7]
    flat = x.reshape(-1)
    got = lowdim_roundtrip(flat, ndims, "xff")
    # the stream's plan is the strict one, and the other would differ
    rows = encoder.upload_rows(x, torch.device("cpu"))
    _, _, _, ws = encoder.encode_device(rows, 1, "xff", lowdim=True)
    zero = ws.numpy() == 0
    strict = planner.build_plan(zero, flat.size, ndims, False)
    assert read_metadata_rle(got)[0] == strict.ngroups
    loose = planner.build_plan(zero, flat.size, ndims, True)
    assert (loose.ngroups, loose.remaining_elems) != (
        strict.ngroups, strict.remaining_elems)


def test_port_decodes_jax_lowdim_streams(rng):
    """A JAX-made u8 d4 stream with runs, and its u16 d2 twin."""
    for es, nd in ((1, 4), (2, 2)):
        x = lowdim_stream(rng, "runs", 2000, nd, es).reshape(-1)
        for codec in ("delta", "xff"):
            buf = jenc.compress(x, nd, codec=codec)
            np.testing.assert_array_equal(sprintz_tpu_torch.decompress(
                buf, codec=codec, elem_sz=es, device="cpu"), x)


@pytest.mark.parametrize("name,codec,ndims,elem_sz", [
    ("delta_8b_d1_sparse", "delta", 1, 1), ("delta_16b_d2_small", "delta", 2, 2),
    ("xff_8b_d3_walk", "xff", 3, 1), ("xff_16b_d1_walk", "xff", 1, 2)])
def test_lowdim_reference_vectors(name, codec, ndims, elem_sz):
    ref = (VECTORS / f"{name}.sprintz").read_bytes()
    want = np.frombuffer((VECTORS / f"{name}.in").read_bytes(),
                         np.uint8 if elem_sz == 1 else np.uint16)
    c = sprintz_tpu_torch.SprintzCodec(codec, elem_sz, device="cpu")
    np.testing.assert_array_equal(c.decompress(ref), want)
    assert c.compress(want, ndims=ndims) == ref


@pytest.mark.parametrize("elem_sz,ndims", [(1, 4), (1, 5), (2, 2), (2, 3)])
def test_layout_boundary(rng, elem_sz, ndims):
    """u8 d4 / u16 d2 are lowdim, u8 d5 / u16 d3 row-major: each side
    matches its golden layout, for both codecs."""
    lowdim = ndims <= (4 if elem_sz == 1 else 2)
    golden = compress_lowdim_rle if lowdim else compress_rowmajor_rle
    x = lowdim_stream(rng, "walk", 203, ndims, elem_sz).reshape(-1)
    for codec in ("delta", "xff"):
        got = encoder.compress(x, ndims, codec=codec, device="cpu")
        assert got == golden(x, ndims, codec=codec)
        assert got == jenc.compress(x, ndims, codec=codec)
        np.testing.assert_array_equal(decoder.decompress(
            got, codec=codec, elem_sz=elem_sz, device="cpu"), x)


@pytest.mark.parametrize("cs", [128, 4096])
@pytest.mark.parametrize("codec", ["delta", "xff"])
def test_lowdim_huffman(rng, cs, codec):
    """+Huf on a lowdim stream: the container at chunk size cs equals the
    JAX package's, and the +Huf codec round-trips in both packages (at cs
    4096, the size this stream gets by default)."""
    x = (np.cumsum(rng.integers(-2, 3, (4000, 4)), axis=0) % 256
         ).astype(np.uint8)
    inner = encoder.compress(x.reshape(-1), 4, codec=codec, device="cpu")
    data = np.frombuffer(inner, np.uint8)
    got = hf.huff_compress(data, chunk_symbols=cs, device="cpu")
    assert got == jhf.huff_compress(data, chunk_symbols=cs)
    assert hf.is_container(got)
    np.testing.assert_array_equal(
        hf.huff_decompress(got, device="cpu"), data)
    if cs == hf.auto_chunk_symbols(data.size):
        c = sprintz_tpu_torch.SprintzCodec(codec, 1, entropy="huffman",
                                           device="cpu")
        buf = c.compress(x)
        assert buf == got
        assert buf == japi.SprintzCodec(codec, 1, entropy="huffman").compress(x)
        np.testing.assert_array_equal(c.decompress(buf), x.reshape(-1))
