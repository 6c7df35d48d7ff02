"""The non-RLE codecs in the PyTorch port (``sprintz_tpu_torch/simple.py``:
"raw", "delta" and the legacy "xff") against the JAX package's
``golden.stream.compress_simple`` / ``decompress_simple``: bytes equal
bytes and values equal values (tolerance 0), each package decoding the
other's streams, at lengths of 1, 127, 128, 129 and 600 rows and one that
is not a multiple of D, over walk, constant, random and zero data. Also
the host library's walk with ``runs=False`` against its plain version
(a last group of all-zero widths that ends the stream included), the
block predictors of ``make_predictor`` against the JAX package's golden
ones, the assembler with a caller's header against its plain version, and
truncated streams, which must raise wherever the JAX package raises."""

import numpy as np
import pytest
import torch

from sprintz_tpu.golden import stream as jstream
from sprintz_tpu_torch import decoder, encoder, simple
from sprintz_tpu_torch.errors import CorruptStreamError
from sprintz_tpu_torch.planner import KIND_DATA, EmissionPlan
from sprintz_tpu_torch.stream_format import read_metadata_rle

DATA = ("walk", "constant", "random", "zero")
ROWS = (1, 127, 128, 129, 600)
CODECS = [("raw", 1), ("raw", 2), ("delta", 1), ("delta", 2), ("xff", 1),
          ("xff", 2)]


def make_data(rng, kind: str, n: int, elem_sz: int) -> np.ndarray:
    """n elements u8/u16 of one of ``DATA``."""
    hi = 1 << (8 * elem_sz)
    if kind == "walk":
        x = np.cumsum(rng.integers(-(hi >> 6), (hi >> 6) + 1, n))
    elif kind == "constant":
        x = np.full(n, int(rng.integers(0, hi)))
    elif kind == "random":
        x = rng.integers(0, hi, n)
    else:
        x = np.zeros(n, np.int64)
    return (x % hi).astype(np.uint8 if elem_sz == 1 else np.uint16)


@pytest.mark.parametrize("ndims", [1, 5, 16, 64])
@pytest.mark.parametrize("codec,elem_sz", CODECS)
def test_simple_matches_jax(rng, codec, elem_sz, ndims):
    lengths = [r * ndims for r in ROWS] + [600 * ndims + ndims // 2 + 1]
    for n in lengths:
        for kind in DATA:
            x = make_data(rng, kind, n, elem_sz)
            what = f"{codec} u{8 * elem_sz} D {ndims} n {n} {kind}"
            want = jstream.compress_simple(x, ndims, codec)
            got = simple.compress_simple(x, ndims, codec, device="cpu")
            assert got == want, what
            out = simple.decompress_simple(want, codec, elem_sz=elem_sz,
                                           device="cpu")
            assert out.dtype == x.dtype and np.array_equal(out, x), what
            np.testing.assert_array_equal(
                jstream.decompress_simple(got, codec, elem_sz=elem_sz), x,
                err_msg=what)


@pytest.mark.parametrize("codec", ["raw", "delta", "xff"])
def test_simple_headerless_matches_jax(rng, codec):
    x = make_data(rng, "walk", 300 * 7 + 3, 1)
    assert (simple.compress_simple(x, 7, codec, write_size=False,
                                   device="cpu")
            == jstream.compress_simple(x, 7, codec, write_size=False))


def walk_fields(idx):
    return (idx.widths, idx.payload_offsets, idx.out_rows, idx.row_bytes,
            idx.total_rows, idx.tail_offset)


@pytest.mark.parametrize("ndims,elem_sz", [(1, 1), (5, 1), (8, 1), (16, 2),
                                           (3, 2)])
def test_walk_without_runs_matches_plain(rng, ndims, elem_sz):
    """The host library's walk with runs=False against its plain version,
    on raw and delta streams of every data kind: zero blocks are data
    blocks of width 0. The zero streams of whole groups end with a group
    of all-zero widths whose header ends the buffer (an empty tail)."""
    for codec in ("raw", "delta"):
        for kind in DATA:
            for rows in (128, 133):
                x = make_data(rng, kind, rows * ndims, elem_sz)
                buf = simple.compress_simple(x, ndims, codec, device="cpu")
                ngroups = x.size // (16 * ndims)
                got = decoder.walk_headers(buf, ngroups, ndims, elem_sz,
                                           start=6, runs=False)
                want = decoder._walk_headers_py(buf, ngroups, ndims,
                                                elem_sz, start=6, runs=False)
                for g, w in zip(walk_fields(got), walk_fields(want)):
                    np.testing.assert_array_equal(g, w)
                assert got.widths.shape[0] == 2 * ngroups
                if kind == "zero" and rows == 128:
                    assert got.tail_offset == len(buf)
                    assert not got.widths.any()


def test_walk_without_runs_last_header_ends_buffer():
    """A stream whose last group has all-zero widths and no tail: the
    header ends the buffer, which the RLE walk would refuse; truncated by
    a byte, both walks raise."""
    x = np.zeros(16 * 3 * 9, np.uint8)
    buf = simple.compress_simple(x, 3, "raw", device="cpu")
    thb = (3 * 3 * 2 + 7) // 8
    assert len(buf) == 6 + 9 * thb
    for walk in (decoder.walk_headers, decoder._walk_headers_py):
        idx = walk(buf, 9, 3, 1, start=6, runs=False)
        assert idx.total_rows == 16 * 9 and idx.tail_offset == len(buf)
        with pytest.raises(CorruptStreamError):
            walk(buf[:-1], 9, 3, 1, start=6, runs=False)


def test_walk_with_runs_unchanged(rng):
    """runs=True (the default) still reads a zero header as a run: the RLE
    stream's walk gives the same index with and without the argument."""
    x = np.repeat(make_data(rng, "walk", 400, 1), 5)
    buf = encoder.compress(x, 5, device="cpu")
    ngroups = read_metadata_rle(buf)[0]
    a = decoder.walk_headers(buf, ngroups, 5, 1)
    b = decoder.walk_headers(buf, ngroups, 5, 1, runs=True)
    c = decoder._walk_headers_py(buf, ngroups, 5, 1)
    for f, g, h in zip(walk_fields(a), walk_fields(b), walk_fields(c)):
        np.testing.assert_array_equal(f, g)
        np.testing.assert_array_equal(f, h)


@pytest.mark.parametrize("meta", [b"", b"\x01\x02\x03\x04\x05\x06",
                                  b"\xff" * 8, None])
def test_assembly_with_a_header_matches_plain(rng, meta):
    """The host library's assembler and its plain version with the header
    the caller gives (none, the simple 6 bytes, the legacy xff 8 bytes) or
    the RLE metadata (None), over an all-data plan with zero-width blocks
    (a zero block at width 0, no payload) and a tail."""
    x = make_data(rng, "walk", 64 * 5 * 4 + 13, 1)
    x[5 * 16:5 * 40] = 0  # zero-width blocks
    rows = encoder.upload_rows(x[:64 * 5 * 4].reshape(-1, 5),
                               torch.device("cpu"))
    widths, hdr, dense, wsums = encoder.encode_errors(rows, 1, False)
    assert (wsums == 0).any()
    plan = EmissionPlan(kinds=np.full(32, KIND_DATA, np.int8),
                        values=np.arange(32, dtype=np.int32), ngroups=16,
                        consumed_blocks=32, remaining_elems=13)
    args = (plan, widths.to(torch.uint8).numpy(), hdr.to(torch.uint8).numpy(),
            dense.numpy(), 5, 1, x[-13:])
    got = encoder.assemble_stream(*args, False, wsums.numpy(), meta=meta)
    assert got == encoder._assemble_stream_py(*args, False, meta=meta)
    if meta is not None:
        assert got.startswith(meta)


@pytest.mark.parametrize("codec,elem_sz", CODECS)
def test_truncated_streams_raise_where_jax_raises(rng, codec, elem_sz):
    ndims = 5
    x = make_data(rng, "walk", 150 * ndims + 2, elem_sz)
    buf = jstream.compress_simple(x, ndims, codec)
    short = jstream.compress_simple(x[:40], ndims, codec)  # verbatim
    raised = 0
    for stream in (buf, short):
        for cut in sorted({1, 2, 5, 7, 9, 40, len(stream) // 2,
                           len(stream) - 3, len(stream) - 1}):
            trunc = stream[:max(len(stream) - cut, 0)]
            try:
                jstream.decompress_simple(trunc, codec, elem_sz=elem_sz)
            except Exception:  # noqa: BLE001 - whatever the JAX package raises
                raised += 1
                with pytest.raises(ValueError):
                    simple.decompress_simple(trunc, codec, elem_sz=elem_sz,
                                             device="cpu")
    assert raised >= 10


@pytest.mark.parametrize("codec,elem_sz", CODECS)
def test_predictors_match_jax(rng, codec, elem_sz):
    """``make_predictor``'s block predictors, a block at a time, against
    the JAX package's golden ones: errors, decoded blocks and runs."""
    ndims = 3
    x = make_data(rng, "walk", 8 * 6 * ndims, elem_sz).reshape(-1, 8, ndims)
    mine = simple.make_predictor(codec, ndims, elem_sz)
    ref = jstream.make_predictor(codec, ndims, elem_sz)
    mine_d = simple.make_predictor(codec, ndims, elem_sz)
    ref_d = jstream.make_predictor(codec, ndims, elem_sz)
    for block in x:
        errs = mine.encode_block(block)
        np.testing.assert_array_equal(errs, ref.encode_block(block))
        np.testing.assert_array_equal(mine_d.decode_block(errs),
                                      ref_d.decode_block(errs))
    np.testing.assert_array_equal(mine_d.decode_run(2), ref_d.decode_run(2))


def test_simple_validation():
    x = np.zeros(300, np.uint8)
    with pytest.raises(ValueError):
        simple.compress_simple(x, 3, "nope", device="cpu")
    with pytest.raises(TypeError):
        simple.compress_simple(x.astype(np.int32), 3, "raw", device="cpu")
    with pytest.raises(ValueError):
        simple.compress_simple(x, 3, "raw", layout="lowdim", device="cpu")
    with pytest.raises(ValueError):
        simple.make_predictor("nope", 3, 1)
