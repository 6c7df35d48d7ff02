"""The univariate façade and the online subsystem in the PyTorch port
(``sprintz_tpu_torch/univariate.py``, ``univariate8b.py`` and
``models/online.py``) against the JAX package's: every method of
``compress_univariate`` / ``decompress_univariate`` ("sprintz" with
``device="cpu"``, both codecs and element sizes) and every public function
of the online module give the same bytes and values (tolerance 0)."""

import numpy as np
import pytest

from sprintz_tpu import univariate as ju
from sprintz_tpu.models import online as jo
from sprintz_tpu_torch import univariate as pu
from sprintz_tpu_torch.models import online as po

LEGACY = ["delta_simple8b", "delta8b", "online8b", "delta_online8b",
          "delta2_online8b", "delta_rle8b", "delta_rle28b", "doubledelta8b",
          "dyndelta8b"]
HOST_METHODS = LEGACY + ["dyndelta", "sprintzpack", "delta", "doubledelta",
                         "tripledelta"]


def series(rng, n: int, elem_sz: int) -> list[np.ndarray]:
    """A walk, a constant run, random values and zeros, n elements each."""
    hi = 1 << (8 * elem_sz)
    dt = np.uint8 if elem_sz == 1 else np.uint16
    return [(np.cumsum(rng.integers(-3, 4, n)) % hi).astype(dt),
            np.full(n, 77, dt), rng.integers(0, hi, n).astype(dt),
            np.zeros(n, dt)]


@pytest.mark.parametrize("method", HOST_METHODS)
def test_host_methods_match_jax(rng, method):
    elem_sz = 1 if method.endswith("8b") else 2
    for n in (0, 1, 7, 64, 65, 1000):
        for x in series(rng, n, elem_sz):
            want = ju.compress_univariate(x, method=method)
            assert pu.compress_univariate(x, method=method) == want, (method, n)
            np.testing.assert_array_equal(
                pu.decompress_univariate(want, method=method, elem_sz=elem_sz),
                ju.decompress_univariate(want, method=method, elem_sz=elem_sz))


@pytest.mark.parametrize("codec,elem_sz", [("delta", 1), ("delta", 2),
                                           ("xff", 1), ("xff", 2)])
def test_sprintz_method_matches_jax(rng, codec, elem_sz):
    """"sprintz": the lowdim path at D 1 on the port's device pass (the
    plain versions here), verbatim short streams and runs included."""
    for n in (5, 127, 3000):
        for x in series(rng, n, elem_sz)[::2]:
            want = ju.compress_univariate(x, codec=codec)
            got = pu.compress_univariate(x, codec=codec, device="cpu")
            assert got == want, (codec, elem_sz, n)
            out = pu.decompress_univariate(got, codec=codec, elem_sz=elem_sz,
                                           device="cpu")
            assert out.dtype == x.dtype and np.array_equal(out, x)


def test_unknown_method_raises():
    for mod in (ju, pu):
        with pytest.raises(ValueError):
            mod.compress_univariate(np.zeros(8, np.uint8), method="nope")
        with pytest.raises(ValueError):
            mod.decompress_univariate(b"\0" * 8, method="nope")
        with pytest.raises(KeyError):
            mod.compress_univariate(np.zeros(8, np.uint8), method="nope8b")


@pytest.mark.parametrize("name", ["DeltaPredictor", "DoubleDeltaPredictor",
                                  "TripleDeltaPredictor",
                                  "MovingAvgPredictor"])
def test_predictive_coding_matches_jax(rng, name):
    for x in series(rng, 300, 2) + [np.zeros(0, np.uint16)]:
        errs = po.predictive_encode(x, getattr(po, name))
        np.testing.assert_array_equal(
            errs, jo.predictive_encode(x, getattr(jo, name)))
        np.testing.assert_array_equal(
            po.predictive_decode(errs, getattr(po, name)),
            jo.predictive_decode(errs, getattr(jo, name)))


def test_predictive_coder_jump_matches_jax():
    for name in ("DeltaPredictor", "DoubleDeltaPredictor",
                 "TripleDeltaPredictor"):
        a = po.PredictiveCoder(getattr(po, name)())
        b = jo.PredictiveCoder(getattr(jo, name)())
        for c in (a, b):
            c.init(100)
            c.jump(65000, 3, 40000)
            c.train(17)
        assert [a.encode_next(v) for v in (5, 65535, 300)] == [
            b.encode_next(v) for v in (5, 65535, 300)]
        assert [a.decode_next(e) for e in (-3, 32767, -32768)] == [
            b.decode_next(e) for e in (-3, 32767, -32768)]
    with pytest.raises(ValueError):
        po.MovingAvgPredictor().jump(1, 2, 3)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_nth_order_delta_matches_jax(rng, order):
    for x in series(rng, 500, 2) + [np.zeros(0, np.uint16)]:
        errs = po.nth_order_delta_encode(x, order)
        np.testing.assert_array_equal(errs,
                                      jo.nth_order_delta_encode(x, order))
        np.testing.assert_array_equal(po.nth_order_delta_decode(errs, order),
                                      jo.nth_order_delta_decode(errs, order))


@pytest.mark.parametrize("loss", [po.LOSS_MAX_ABS, po.LOSS_SUM_LOG_ABS])
def test_dynamic_delta_matches_jax(rng, loss):
    for x in series(rng, 203, 2) + [np.zeros(1, np.uint16)]:
        errs, choices = po.dynamic_delta_zigzag_encode(x, loss)
        jerrs, jchoices = jo.dynamic_delta_zigzag_encode(x, loss)
        np.testing.assert_array_equal(errs, jerrs)
        np.testing.assert_array_equal(choices, jchoices)
        np.testing.assert_array_equal(
            po.dynamic_delta_zigzag_decode(errs, choices),
            jo.dynamic_delta_zigzag_decode(errs, choices))
        buf = po.dynamic_delta_pack_u16(x, loss)
        assert buf == jo.dynamic_delta_pack_u16(x, loss)
        np.testing.assert_array_equal(po.dynamic_delta_unpack_u16(buf), x)


@pytest.mark.parametrize("zigzag", [False, True])
def test_sprintzpack_and_zigzag_pack_match_jax(rng, zigzag):
    for x in series(rng, 203, 2) + [np.zeros(0, np.uint16)]:
        payload, headers = po.sprintzpack_encode_u16(x, zigzag=zigzag)
        assert (payload, headers) == jo.sprintzpack_encode_u16(x,
                                                               zigzag=zigzag)
        np.testing.assert_array_equal(
            po.sprintzpack_decode_u16(payload, headers, x.size,
                                      zigzag=zigzag), x)
        buf = po.sprintzpack_pack_u16(x, zigzag=zigzag)
        assert buf == jo.sprintzpack_pack_u16(x, zigzag=zigzag)
        np.testing.assert_array_equal(
            po.sprintzpack_unpack_u16(buf, zigzag=zigzag), x)
        zz = po.zigzag_pack_u16(x)
        assert zz == jo.zigzag_pack_u16(x)
        np.testing.assert_array_equal(po.zigzag_unpack_u16(zz), x)
