"""The port's batch API against the JAX package's, exactly (integers: the
tolerance is zero): ``encoder.compress_batch`` bytes equal the JAX
package's ``encoder.compress_batch`` and each stream's own ``compress``,
and ``decoder.decompress_batch`` equals the JAX package's
``decompress_batch`` and the input, for delta in both layouts (u8 D 1-5
and 9, u16 D 1, 2, 5, 9) at S 1, 2 and 5, with runs and with rows that are
not a multiple of 8; streams too short to code, a batch with no whole
block, mixed batches (verbatim, another ndims, all-tail, all-run), a
corrupt stream, the empty list; and ``SprintzCodec``'s routing
(``tests/test_jax_backend.py``'s batch cases: the dtype ``TypeError``,
+Huf one stream at a time). FIRE's cases are in
``test_torch_batch_xff.py``."""

import numpy as np
import pytest

from sprintz_tpu import api as japi
from sprintz_tpu import decoder as jdec
from sprintz_tpu import encoder as jenc
from sprintz_tpu_torch import SprintzCodec, CorruptStreamError
from sprintz_tpu_torch import decoder as tdec
from sprintz_tpu_torch import encoder as tenc

# (elem_sz, ndims, streams, rows): row-major and lowdim widths, S 1, 2, 5
BATCH_SHAPES = [(1, 1, 5, 403), (1, 2, 2, 256), (1, 3, 1, 300),
                (1, 4, 5, 161), (1, 5, 2, 203), (1, 9, 5, 96),
                (2, 1, 2, 305), (2, 2, 5, 120), (2, 5, 1, 250),
                (2, 9, 2, 131)]


def batch_streams(rng, es: int, ndims: int, nstreams: int,
                  nrows: int) -> np.ndarray:
    """(S, rows, D) walks; every other stream has runs (constant stretches,
    one from the start), so the batch mixes streams with and without."""
    dt = np.uint8 if es == 1 else np.uint16
    x = (np.cumsum(rng.integers(-5, 6, (nstreams, nrows, ndims)), axis=1)
         % (1 << (8 * es))).astype(dt)
    x[::2, : nrows // 5] = 0
    x[::2, nrows // 2: nrows // 2 + 40] = x[::2, nrows // 2 - 1: nrows // 2]
    return x


def assert_batch_equals_jax(x: np.ndarray, codec: str) -> None:
    es, ndims = x.dtype.itemsize, x.shape[2]
    got = tenc.compress_batch(x, codec, device="cpu")
    assert got == jenc.compress_batch(x, codec)
    assert got == [tenc.compress(s.reshape(-1), ndims, codec, device="cpu")
                   for s in x]
    want = jdec.decompress_batch(got, codec, es)
    out = tdec.decompress_batch(got, codec, es, device="cpu")
    assert len(out) == len(x)
    for o, w, s in zip(out, want, x):
        assert o.dtype == w.dtype
        np.testing.assert_array_equal(o, w)
        np.testing.assert_array_equal(o, s.reshape(-1))


@pytest.mark.parametrize("es,ndims,nstreams,nrows", BATCH_SHAPES)
def test_delta_batch_equals_jax(es, ndims, nstreams, nrows):
    rng = np.random.default_rng(es * 100 + ndims * 10 + nstreams)
    assert_batch_equals_jax(batch_streams(rng, es, ndims, nstreams, nrows),
                            "delta")


@pytest.mark.parametrize("codec", ["delta", "xff"])
@pytest.mark.parametrize("shape", [(3, 10, 4), (2, 7, 20)])
def test_short_batches_equal_jax(codec, shape):
    """Streams too short to code (n < 128: verbatim), and streams of no
    whole block whose elements all go to the verbatim tail."""
    rng = np.random.default_rng(sum(shape))
    assert_batch_equals_jax(rng.integers(0, 256, shape).astype(np.uint8),
                            codec)


def mixed_bufs(rng):
    """A batch of one ndims (9) with a short verbatim stream, a stream of
    another ndims (5), a stream with a tail, an all-tail stream, an
    all-run stream and two plain walks; then another 5-dim stream."""
    def walk(n, d):
        return (np.cumsum(rng.integers(-5, 6, (n, d)), axis=0)
                % 256).astype(np.uint8)

    arrays = [walk(300, 9), walk(7, 9), walk(200, 5), walk(205, 9),
              walk(15, 20)[:, :9].copy(), np.zeros((400, 9), np.uint8),
              walk(96, 9), walk(300, 5)]
    return arrays, [tenc.compress(a.reshape(-1), a.shape[1], device="cpu")
                    for a in arrays]


def test_mixed_batch_equals_jax():
    arrays, bufs = mixed_bufs(np.random.default_rng(7))
    # the JAX package walks every stream with the first stream's ndims, so
    # its batch takes the stream of another ndims only where that walk
    # happens not to overrun: here it does not, as the stream lies last
    order = [0, 1, 3, 4, 5, 6, 2]
    bufs = [bufs[i] for i in order]
    want = jdec.decompress_batch(bufs, "delta", 1)
    got = tdec.decompress_batch(bufs, "delta", 1, device="cpu")
    for o, w, i in zip(got, want, order):
        np.testing.assert_array_equal(o, w)
        np.testing.assert_array_equal(o, arrays[i].reshape(-1))


def test_other_ndims_decodes_where_jax_raises():
    """The JAX package's batch walks a stream of another ndims with the
    first stream's and raises when that walk overruns; the port routes
    such a stream to ``decompress`` without that walk."""
    arrays, bufs = mixed_bufs(np.random.default_rng(7))
    bufs = [bufs[0], bufs[7]]  # the 5-dim stream walked as 9 overruns
    with pytest.raises(ValueError):
        jdec.decompress_batch(bufs, "delta", 1)
    got = tdec.decompress_batch(bufs, "delta", 1, device="cpu")
    np.testing.assert_array_equal(got[0], arrays[0].reshape(-1))
    np.testing.assert_array_equal(got[1], arrays[7].reshape(-1))


def test_corrupt_and_empty_batches():
    arrays, bufs = mixed_bufs(np.random.default_rng(8))
    cut = bufs[0][: len(bufs[0]) // 2]
    with pytest.raises(CorruptStreamError):
        tdec.decompress_batch([bufs[3], cut], "delta", 1, device="cpu")
    with pytest.raises(ValueError):
        jdec.decompress_batch([bufs[3], cut], "delta", 1)
    with pytest.raises(CorruptStreamError):
        tdec.decompress_batch([bufs[0], b"\x00" * 5], "delta", 1,
                              device="cpu")
    assert tdec.decompress_batch([], "delta", 1, device="cpu") == []
    assert SprintzCodec(device="cpu").compress_batch([]) == []
    assert SprintzCodec(device="cpu").decompress_batch([]) == []


@pytest.mark.parametrize("codec,es,ndims", [("delta", 1, 4), ("xff", 2, 9)])
def test_api_batch_roundtrip(codec, es, ndims):
    """``tests/test_jax_backend.py::test_api_batch_roundtrip`` on the port,
    and the same bytes as the JAX package's ``SprintzCodec``."""
    rng = np.random.default_rng(es + ndims)
    dt = np.uint8 if es == 1 else np.uint16
    c = SprintzCodec(codec, es, device="cpu")
    arrs = [(np.cumsum(rng.integers(-5, 6, (1200, ndims)), axis=0)
             % (1 << (8 * es))).astype(dt) for _ in range(4)]
    bufs = c.compress_batch(arrs)
    assert bufs == [c.compress(a) for a in arrs]
    assert bufs == japi.SprintzCodec(codec, es).compress_batch(arrs)
    for a, o in zip(arrs, c.decompress_batch(bufs)):
        np.testing.assert_array_equal(o, a.reshape(-1))


def test_api_batch_routing(monkeypatch):
    """The batch pass runs only for same-shape 2-D arrays of the codec's
    dtype with entropy "none" and no ``ndims``; the rest go one by one,
    and a wrong dtype raises ``TypeError`` as ``compress`` does
    (``tests/test_jax_backend.py::test_api_batch_dtype_mismatch_raises``)."""
    rng = np.random.default_rng(3)
    calls = []
    real = tenc.compress_batch
    monkeypatch.setattr(tenc, "compress_batch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    c = SprintzCodec("delta", 1, device="cpu")
    arrs = [rng.integers(0, 1 << 16, (160, 4)).astype(np.uint16)
            for _ in range(2)]
    with pytest.raises(TypeError):
        c.compress_batch(arrs)
    with pytest.raises(TypeError):  # a wrong dtype past the first array
        c.compress_batch([arrs[0].astype(np.uint8), arrs[1]])
    assert not calls
    ok = [a.astype(np.uint8) for a in arrs]
    assert c.compress_batch(ok) == [c.compress(a) for a in ok]
    assert len(calls) == 1
    for other in ([ok[0], ok[1][:80]], [a.reshape(-1) for a in ok]):
        assert c.compress_batch(other) == [c.compress(a) for a in other]
    assert c.compress_batch(ok, ndims=8) == [c.compress(a, ndims=8)
                                             for a in ok]
    assert len(calls) == 1


def test_api_batch_huffman_goes_per_stream():
    rng = np.random.default_rng(4)
    arrs = [(np.cumsum(rng.integers(-2, 3, (2000, 8)), axis=0) % 256
             ).astype(np.uint8) for _ in range(3)]
    c = SprintzCodec("delta", 1, entropy="huffman", device="cpu")
    bufs = c.compress_batch(arrs)
    assert bufs == [c.compress(a) for a in arrs]
    assert bufs == japi.SprintzCodec("delta", 1,
                                     entropy="huffman").compress_batch(arrs)
    for a, o in zip(arrs, c.decompress_batch(bufs)):
        np.testing.assert_array_equal(o, a.reshape(-1))
