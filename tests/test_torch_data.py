"""The dataset layer in the PyTorch port (``sprintz_tpu_torch/data``)
against the JAX package's ``data``: quantizers, the benchmark file layout,
the synthetic corpora and the real-format parsers over the checked-in
``tests/data/mini_corpus``, all equal bit for bit (tolerance 0); and the
parsed corpora through the port's codec (``device="cpu"``): lossless, and
delta's bytes the JAX package's."""

import pathlib

import numpy as np
import pytest

from sprintz_tpu import api as japi
from sprintz_tpu.data import corpus as jc
from sprintz_tpu.data import loaders as jl
from sprintz_tpu_torch import SprintzCodec
from sprintz_tpu_torch import data as pdata
from sprintz_tpu_torch.data import corpus as pc
from sprintz_tpu_torch.data import loaders as pl

MINI = pathlib.Path(__file__).parent / "data" / "mini_corpus"
CORPORA = ["ucr", "msrc12", "pamap", "ampds", "uci_gas"]


def assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_matches_jax(dtype, axis):
    mat = np.random.default_rng(3).normal(0, 10, (1000, 4))
    mat[:, 2] = 7.0  # a constant column
    assert_same(pc.quantize(mat, dtype, axis), jc.quantize(mat, dtype, axis))


@pytest.mark.parametrize("name", sorted(pc.CORPUS_PROFILES))
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_synthetic_corpus_matches_jax(name, dtype):
    assert pc.CORPUS_PROFILES[name] == jc.CORPUS_PROFILES[name]
    got = pc.synthetic_corpus(name, nrows=3000, dtype=dtype, seed=5)
    assert_same(got, jc.synthetic_corpus(name, nrows=3000, dtype=dtype,
                                         seed=5))
    assert got.shape == (3000, pc.CORPUS_PROFILES[name]["ndims"])


@pytest.mark.parametrize("order", ["c", "f"])
def test_dat_layout_matches_jax(tmp_path, order):
    mat = np.random.default_rng(4).integers(0, 65536, (500, 6)).astype(
        np.uint16)
    p = pc.write_dat(tmp_path / "p", "foo", mat, order=order)
    j = jc.write_dat(tmp_path / "j", "foo", mat, order=order)
    assert p.relative_to(tmp_path / "p") == j.relative_to(tmp_path / "j")
    assert p.read_bytes() == j.read_bytes()
    back = pc.read_dat(p, np.uint16, ndims=6)
    assert_same(back, jc.read_dat(j, np.uint16, ndims=6))
    if order == "c":
        np.testing.assert_array_equal(back, mat)


def test_load_dataset_matches_jax(tmp_path, monkeypatch):
    """The synthetic stand-in without a data directory; with one
    ($SPRINTZ_DATA_DIR or ``data_dir``), its .dat files."""
    monkeypatch.delenv("SPRINTZ_DATA_DIR", raising=False)
    assert_same(pc.load_dataset("ucr_like", nrows=2000),
                jc.load_dataset("ucr_like", nrows=2000))
    mat = pc.synthetic_corpus("ampd_like", nrows=400, seed=9)
    d = tmp_path / "rowmajor" / "uint8" / "ampd"
    d.mkdir(parents=True)
    (d / "a.dat").write_bytes(mat[:150].tobytes())
    (d / "b.dat").write_bytes(mat[150:].tobytes())
    got = pc.load_dataset("ampd_like", data_dir=str(tmp_path))
    assert_same(got, jc.load_dataset("ampd_like", data_dir=str(tmp_path)))
    np.testing.assert_array_equal(got, mat)
    monkeypatch.setenv("SPRINTZ_DATA_DIR", str(tmp_path))
    assert_same(pc.load_dataset("ampd_like"), got)
    assert_same(pdata.load_dataset("ampd_like"), jc.load_dataset("ampd_like"))


@pytest.mark.parametrize("name", CORPORA)
def test_parse_mini_corpus_matches_jax(name):
    got = pl.load_corpus(name, MINI)
    assert_same(got, jl.load_corpus(name, MINI))
    assert got.ndim == 2 and np.isfinite(got).all()


def test_parsers_match_jax():
    f = sorted((MINI / "msrc12").glob("*.csv"))[0]
    assert_same(pl.parse_msrc12(f), jl.parse_msrc12(f))
    f = sorted((MINI / "pamap").glob("*.dat"))[0]
    assert_same(pl.parse_pamap(f), jl.parse_pamap(f))
    f = sorted((MINI / "ampds").glob("*.csv"))[0]
    assert_same(pl.parse_ampds(f), jl.parse_ampds(f))
    f = sorted((MINI / "uci_gas").glob("*.txt"))[0]
    assert_same(pl.parse_uci_gas(f), jl.parse_uci_gas(f))
    ds = MINI / "ucr" / "MiniRamp"
    for a, b in zip(pl.parse_ucr_dataset(ds), jl.parse_ucr_dataset(ds)):
        assert_same(a, b)
    for a, b in zip(pl.parse_ucr_file(ds / "MiniRamp_TRAIN"),
                    jl.parse_ucr_file(ds / "MiniRamp_TRAIN")):
        assert_same(a, b)
    assert_same(pl.load_ucr(ds), jl.load_ucr(ds))
    mats = [np.arange(6.0).reshape(3, 2), np.ones((2, 2)), np.zeros((1, 2))]
    for n in (0, 1, 5):
        assert_same(pl.concat_and_interpolate(mats, n),
                    jl.concat_and_interpolate(mats, n))


def test_corpus_to_benchmark_matches_jax(tmp_path):
    p = pl.corpus_to_benchmark("ampds", MINI, tmp_path / "p")
    j = jl.corpus_to_benchmark("ampds", MINI, tmp_path / "j")
    assert len(p) == len(j) == 4
    for a, b in zip(p, j):
        assert a.relative_to(tmp_path / "p") == b.relative_to(tmp_path / "j")
        assert a.read_bytes() == b.read_bytes()


def test_make_mini_corpus_matches_jax_and_checked_in(tmp_path):
    pl.make_mini_corpus(tmp_path / "p")
    jl.make_mini_corpus(tmp_path / "j")
    files = sorted(f.relative_to(tmp_path / "p")
                   for f in (tmp_path / "p").rglob("*") if f.is_file())
    assert files == sorted(f.relative_to(tmp_path / "j")
                           for f in (tmp_path / "j").rglob("*")
                           if f.is_file())
    for f in files:
        assert (tmp_path / "p" / f).read_bytes() == (
            tmp_path / "j" / f).read_bytes()
        assert (tmp_path / "p" / f).read_bytes() == (MINI / f).read_bytes()


@pytest.mark.parametrize("name", CORPORA)
def test_mini_corpus_through_the_codec(name):
    """The parsed, quantized corpus through the port's codec: lossless for
    delta and xff at u8 and u16; delta u8's bytes equal the JAX package's."""
    raw = pl.load_corpus(name, MINI)
    for dtype in (np.uint8, np.uint16):
        mat = pc.quantize(raw, dtype=dtype)
        es = np.dtype(dtype).itemsize
        for codec in ("delta", "xff"):
            sc = SprintzCodec(codec, es, device="cpu")
            buf = sc.compress(mat)
            np.testing.assert_array_equal(sc.decompress(buf),
                                          mat.reshape(-1))
            if codec == "delta" and es == 1:
                assert buf == japi.SprintzCodec(codec, es).compress(mat)
