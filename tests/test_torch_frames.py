"""The DataFrame pipeline in the PyTorch port (``sprintz_tpu_torch/frames``)
against the JAX package's ``frames``, on the same numpy-seeded frames.

Exact equality (tolerance 0): quantization parameters and codes, every
codec chain's encoded columns and headers, and the decoded frames; a frame
encoded by either package decodes in the other. The ``Sprintz`` column
codec runs with ``device="cpu"``. Storage round-trips through pandas,
which only ``frames.storage`` needs: importing ``sprintz_tpu_torch.frames``
must work without it."""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from sprintz_tpu import frames as jf
from sprintz_tpu.frames import codecs as jcodecs
from sprintz_tpu.frames import storage as jstorage
from sprintz_tpu_torch import frames as pf
from sprintz_tpu_torch.frames import codecs as pcodecs
from sprintz_tpu_torch.frames import storage as pstorage


def make_df(seed: int, n: int = 2000) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "walk16": (np.cumsum(rng.integers(-3, 4, n)) & 0xFFFF).astype(np.uint16),
        "small8": rng.integers(0, 5, n).astype(np.uint8),
        "wide32": np.cumsum(rng.integers(-100, 101, n)).astype(np.int32),
        "price": np.round(rng.normal(100, 5, n), 2),
        "flags": rng.integers(0, 2, n).astype(np.uint8),
    })


class Frame:
    """A stand-in frame: ``.columns`` and ``frame[c].to_numpy()``."""

    class _Col:
        def __init__(self, v):
            self.v = v
            self.dtype = v.dtype

        def to_numpy(self):
            return self.v

    def __init__(self, cols: dict):
        self._cols = cols
        self.columns = list(cols)

    def __getitem__(self, c):
        return self._Col(self._cols[c])


# chains, each made of the JAX package's codecs or of the port's
CHAINS = {
    "delta_zigzag": lambda m: [m.Delta(), m.Zigzag()],
    "doubledelta_zigzag": lambda m: [m.DoubleDelta(), m.Zigzag()],
    "dynamicdelta": lambda m: [m.DynamicDelta()],
    "byteshuffle": lambda m: [m.ByteShuffle()],
    "quantize_delta": lambda m: [m.Quantize(), m.Delta()],
    "codecsearch": lambda m: [m.CodecSearch()],
    "quantize_zlib": lambda m: [m.Quantize(), m.Zlib()],
    "lzma": lambda m: [m.Lzma()],
    "bz2": lambda m: [m.Bz2()],
    "full": lambda m: [m.Quantize(), m.DynamicDelta(), m.Zigzag(), m.Zlib()],
}


def jax_chain(name):
    return CHAINS[name](jcodecs)


def port_chain(name):
    return CHAINS[name](pcodecs)


def assert_same_encoding(a, b):
    (ea, ha), (eb, hb) = a, b
    assert json.dumps(ha) == json.dumps(hb)
    assert ea.keys() == eb.keys()
    for name in ea:
        assert list(ea[name]) == list(eb[name])
        for c in ea[name]:
            x, y = np.asarray(ea[name][c]), np.asarray(eb[name][c])
            assert x.dtype == y.dtype, (name, c)
            assert x.tobytes() == y.tobytes(), (name, c)


def assert_decodes(dec, dfs):
    for name, df in dfs.items():
        for c in df.columns:
            a, b = df[c].to_numpy(), dec[name][c]
            assert a.dtype == b.dtype and np.array_equal(
                a, b, equal_nan=np.issubdtype(a.dtype, np.floating)), (name, c)


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_chain_matches_jax(chain):
    """Encoded columns and headers equal; each package decodes the other's
    frames."""
    dfs = {"a": make_df(1), "b": make_df(2, 777)}
    jchain, pchain = jax_chain(chain), port_chain(chain)
    j = jf.encode(dfs, jchain)
    p = pf.encode(dfs, pchain)
    assert_same_encoding(p, j)
    assert_decodes(pf.decode(*j, pchain), dfs)
    assert_decodes(jf.decode(*p, jchain), dfs)
    pr, jr = (pf.encode_measure_decode(dfs, port_chain(chain)),
              jf.encode_measure_decode(dfs, jax_chain(chain)))
    assert dataclasses.asdict(pr) == dataclasses.asdict(jr) and pr.lossless
    assert pr.ratio == jr.ratio


@pytest.mark.parametrize("codec", ["delta", "xff"])
def test_sprintz_column_codec_matches_jax(codec):
    """u8 and u16 columns through the port's codec (the lowdim layout at
    D 1) give the JAX package's bytes, a column short enough to be stored
    verbatim included; the headers are the same JSON. (xff: the u16 walk
    alone, a shorter one, as the JAX package compiles its scans a dtype.)"""
    df = make_df(3, 2000)[["walk16", "small8", "wide32"]]
    if codec == "xff":
        df = make_df(3, 500)[["walk16", "wide32"]]
    short = Frame({"w": df["walk16"].to_numpy()[:7]})
    for dfs in ({"d": df}, {"s": short}):
        j = jf.encode(dfs, [jcodecs.Sprintz(codec)])
        p = pf.encode(dfs, [pcodecs.Sprintz(codec, device="cpu")])
        assert_same_encoding(p, j)
        assert_decodes(pf.decode(*j, [pcodecs.Sprintz(codec, device="cpu")]),
                       dfs)
        assert_decodes(jf.decode(*p, [jcodecs.Sprintz(codec)]), dfs)
    res = pf.encode_measure_decode({"d": df}, [pcodecs.Sprintz(
        codec, device="cpu")])
    assert res.lossless and res.ratio > 1.2


def test_stand_in_frame_matches_pandas():
    """``encode`` / ``decode`` need only ``.columns`` and ``to_numpy``."""
    df = make_df(4)
    fr = Frame({c: df[c].to_numpy() for c in df.columns})
    chain = port_chain("full")
    assert_same_encoding(pf.encode({"x": fr}, chain),
                         pf.encode({"x": df}, port_chain("full")))
    assert pf.encode_measure_decode([fr], port_chain("full")).lossless


@pytest.mark.parametrize("case", ["base10", "nans", "all_nan", "wide",
                                  "not_quantizable", "rescale_u8",
                                  "rescale_u16"])
def test_quantize_matches_jax(case):
    rng = np.random.default_rng(11)
    mode = "lossless_base10"
    x = np.round(rng.normal(50, 10, 3000), 3)
    if case == "nans":
        x = np.round(rng.normal(0, 1, 1000), 2)
        x[::17] = np.nan
    elif case == "all_nan":
        x = np.full(10, np.nan)
    elif case == "wide":
        x = np.round(rng.normal(0, 1e6, 500), 1)
    elif case == "not_quantizable":
        x = rng.normal(0, 1, 100)
    elif case.startswith("rescale"):
        mode = case
        x = rng.normal(0, 300, 400)
    p, j = pf.infer_qparams(x, mode=mode), jf.infer_qparams(x, mode=mode)
    if j is None:
        assert p is None
        return
    assert repr(dataclasses.asdict(p)) == repr(dataclasses.asdict(j))
    q = pf.quantize(x, p)
    np.testing.assert_array_equal(q, jf.quantize(x, j))
    back = pf.dequantize(q, p)
    np.testing.assert_array_equal(back, jf.dequantize(q, j))
    if mode == "lossless_base10":
        assert np.array_equal(back, x, equal_nan=True)


def test_colsum_predictor_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 100, 500).astype(np.int64)
    b = rng.integers(0, 100, 500).astype(np.int64)
    df = pd.DataFrame({"a": a, "b": b,
                       "total": a + b + rng.integers(-2, 3, 500),
                       "t3": (3 * a + rng.integers(0, 2, 500)).astype(np.int32)})
    for args in ((["a", "b"], "total"), (["a"], "t3", [3.0]),
                 (["a", "b"], "total", [[0.25, 0.5, 0.25], 1.0])):
        pchain = [pcodecs.ColSumPredictor(*args), pcodecs.Delta()]
        jchain = [jcodecs.ColSumPredictor(*args), jcodecs.Delta()]
        assert pchain[0].name() == jchain[0].name()
        p, j = pf.encode({"x": df}, pchain), jf.encode({"x": df}, jchain)
        assert_same_encoding(p, j)
        assert_decodes(pf.decode(*j, pchain), {"x": df})


def test_storage_backends_match_jax(tmp_path):
    """Each backend's files: the port's load the JAX package's and back;
    the smart choice is the same backend."""
    df = make_df(5)
    backends = pstorage.available_backends()
    assert backends.keys() == jstorage.available_backends().keys()
    for name in backends:
        pp = pstorage.save_df(df, tmp_path / f"p_{name}", fmt=name)
        jp = jstorage.save_df(df, tmp_path / f"j_{name}", fmt=name)
        assert pp.suffix == jp.suffix
        for back in (pstorage.load_df(jp), jstorage.load_df(pp)):
            for c in df.columns:
                np.testing.assert_array_equal(back[c].to_numpy(),
                                              df[c].to_numpy(), err_msg=name)
    ps_ = pstorage.save_df(df, tmp_path / "psmart", fmt="smart")
    js_ = jstorage.save_df(df, tmp_path / "jsmart", fmt="smart")
    assert ps_.suffix == js_.suffix
    assert set(pstorage.load_df(ps_).columns) == set(df.columns)
    with pytest.raises(ValueError):
        pstorage.load_df(tmp_path / "nothing.xyz")


def test_frames_import_without_pandas():
    code = ("import sys; sys.modules['pandas'] = None; "
            "sys.modules['pyarrow'] = None; "
            "import sprintz_tpu_torch.frames as f, sprintz_tpu_torch.data; "
            "import sprintz_tpu_torch.frames.storage; "
            "assert 'jax' not in sys.modules; print(f.Sprintz().name())")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "Sprintz", r.stderr


def test_same_exports_as_jax():
    assert ({n for n in dir(pf) if not n.startswith("_")}
            == {n for n in dir(jf) if not n.startswith("_")})
