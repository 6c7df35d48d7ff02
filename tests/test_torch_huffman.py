"""The +Huf entropy stage of the PyTorch port against the JAX package: the
table build, the chunk-parallel decode (K6's plain version against the
Pallas kernel in interpret mode, the XLA scan and the numpy decoder), the
chunked encode, the container's head, escapes and edge streams, and the
+Huf codec. Every comparison is bit-exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sprintz_tpu
import sprintz_tpu.entropy.huffman as jhf
from sprintz_tpu.entropy import pallas_huffman as jph
from conftest import make_stream
import sprintz_tpu_torch
from sprintz_tpu_torch.entropy import huffman as hf
from sprintz_tpu_torch.ops import huffman_kernels as hk


def skewed(rng, n: int) -> np.ndarray:
    """Bytes whose Huffman code needs the 12-bit length limit."""
    return np.minimum(rng.geometric(0.35, n) - 1, 255).astype(np.uint8)


def streams(rng, n: int) -> dict:
    return {"rand": make_stream(rng, n, 1, "rand"),
            "small": make_stream(rng, n, 1, "small"),
            "sparse": make_stream(rng, n, 1, "sparse"),
            "skewed": skewed(rng, n)}


def test_tables_match_jax(rng):
    cases = list(streams(rng, 20_000).values())
    fib = np.repeat(np.arange(30), [int(1.6 ** k) + 1 for k in range(30)])
    cases += [fib.astype(np.uint8), np.zeros(0, np.uint8),
              np.full(9, 7, np.uint8), np.arange(256, dtype=np.uint8)]
    for data in cases:
        got, want = hf.build_table(data), jhf.build_table(data)
        np.testing.assert_array_equal(got.lengths, want.lengths)
        np.testing.assert_array_equal(got.codes, want.codes)
        for g, w in zip(got.canonical_tables(), want.canonical_tables()):
            np.testing.assert_array_equal(g, w)
        assert hf._pack_table(got) == jhf._pack_table(want)
    assert max(hf.build_table(fib.astype(np.uint8)).lengths) == 12


def port_decode_plain(buf: bytes) -> np.ndarray:
    """K6's plain version on a container, as huff_decompress calls it."""
    n, cs, _, t, sizes, offsets = hf._parse(buf)
    syms, nbad = hk.split_decoded(hk.decode_chunks(
        torch.from_numpy(np.frombuffer(buf, np.uint8).copy()),
        torch.from_numpy(offsets), torch.from_numpy(sizes.astype(np.int32)),
        *hf.decode_tables(t, torch.device("cpu")), cs, n), n)
    assert int(nbad) == 0
    return syms.numpy()


@pytest.mark.parametrize("cs", [8, 16])
def test_decode_matches_pallas_interpret(rng, cs):
    """JAX's K6 in interpret mode compiles only at small chunk sizes; 1023
    and a half chunks pad to its 1024-chunk lane tile."""
    data = make_stream(rng, cs * 1023 + cs // 2 + 1, 1, "small")
    buf = jhf.huff_compress(data, chunk_symbols=cs, allow_stored=False)
    words, tables, cs2, nchunks, n = jhf.device_decode_prep(buf)
    assert jph.decode_pallas_available(words.shape[1], cs2)
    want = jph.decode_jax_pallas(words, tables, cs2, nchunks, n,
                                 interpret=True, fuse_perm=True)
    got = port_decode_plain(buf)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data)


@pytest.mark.parametrize("cs", [62, 128, 4096])
def test_decode_matches_xla_scan_and_numpy(rng, cs):
    for kind, data in streams(rng, 3 * cs + cs // 3).items():
        buf = jhf.huff_compress(data, chunk_symbols=cs, allow_stored=False)
        got = port_decode_plain(buf)
        np.testing.assert_array_equal(got, data, err_msg=kind)
        np.testing.assert_array_equal(
            got, jhf.huff_decompress(buf, backend="numpy"), err_msg=kind)
        if kind == "skewed":  # one XLA scan per cs: its compile is the cost
            words, tables, cs2, nchunks, n = jhf.device_decode_prep(buf)
            xla = jhf.get_decode_device()(
                jnp.asarray(words), *(jnp.asarray(x) for x in tables), cs2)
            np.testing.assert_array_equal(
                got, np.asarray(xla[:nchunks]).reshape(-1)[:n])
        assert hf.huff_decompress(buf, device="cpu").tobytes() == data.tobytes()


@pytest.mark.parametrize("cs", [64, 128, 4096])
def test_encode_matches_host_and_device_encoders(rng, cs):
    for kind, data in streams(rng, 5 * cs + 11).items():
        want = jhf._huff_compress_host(data, cs, None)
        assert want == jhf.huff_compress_device(data, cs), kind
        got = hf.huff_compress(data, cs, allow_stored=False, device="cpu")
        assert got == want, kind
        t = hf.build_table(data)
        payload, sizes = hk.encode_chunks(torch.from_numpy(data.copy()),
                                          *hf.encode_table(t, "cpu"), cs)
        n, _, nchunks, _, jsizes, offsets = jhf._parse(want)
        np.testing.assert_array_equal(sizes.numpy(), jsizes)
        assert payload.numpy().tobytes() == want[int(offsets[0]):]


def test_auto_chunk_size_matches_jax(rng, monkeypatch):
    """The chunk size turns at 4 MiB of stream, as the JAX package's does;
    the bytes agree on both sides of the turn (tried at a small turn,
    since both read their threshold at call time)."""
    monkeypatch.delenv("SPRINTZ_HUFF_CHUNK", raising=False)
    turn = hf.AUTO_CHUNK_MIN_BYTES
    assert turn == jhf.HUFF_DEVICE_MIN_BYTES
    for n in (0, 1, 4096, turn - 1, turn, 1 << 23):
        assert hf.auto_chunk_symbols(n) == jhf.auto_chunk_symbols(n), n
    monkeypatch.setattr(hf, "AUTO_CHUNK_MIN_BYTES", 9000)
    monkeypatch.setattr(jhf, "HUFF_DEVICE_MIN_BYTES", 9000)
    for n in (8999, 9000):
        data = make_stream(rng, n, 1, "small")
        got = hf.huff_compress(data, device="cpu")
        assert got == jhf.huff_compress(data), n
        assert hf._parse(got)[1] == (128 if n == 9000 else 4096)


def test_stored_escape(rng):
    data = rng.integers(0, 256, 50_000).astype(np.uint8)
    got = hf.huff_compress(data, chunk_symbols=128, device="cpu")
    assert got == jhf.huff_compress(data, chunk_symbols=128)
    assert len(got) == data.size + 12 and hf.is_container(got)
    assert hf.huff_decompress(got, device="cpu").tobytes() == data.tobytes()
    coded = hf.huff_compress(data, chunk_symbols=128, allow_stored=False,
                             device="cpu")
    assert coded == jhf.huff_compress(data, chunk_symbols=128,
                                      allow_stored=False)
    assert len(coded) > len(got)
    np.testing.assert_array_equal(hf.huff_decompress(coded, device="cpu"),
                                  data)


def test_edge_streams(rng):
    """n = 0 (one empty chunk) and n = 1; a v1 container and a v2 one with
    u32 sizes, which the encoder never writes but both decoders read."""
    for n in (0, 1):
        data = rng.integers(0, 256, n).astype(np.uint8)
        for cs in (None, 5):
            got = hf.huff_compress(data, cs, device="cpu")
            assert got == jhf.huff_compress(data, cs)
            assert hf.is_container(got)
            np.testing.assert_array_equal(
                hf.huff_decompress(got, device="cpu"), data)
    data = make_stream(rng, 3000, 1, "small")
    v2 = hf.huff_compress(data, chunk_symbols=700, device="cpu")
    n, cs, nchunks, _, sizes, _ = hf._parse(v2)
    head = np.frombuffer(v2[:12], np.uint32).copy()
    payload = v2[140 + 2 * nchunks:]
    u32_sizes = sizes.astype(np.uint32).tobytes()
    v1 = (np.array([n, cs, nchunks], np.uint32).tobytes() + v2[12:140]
          + u32_sizes + payload)
    v2_u32 = (head[:1].tobytes() + np.array([cs, 1], np.uint16).tobytes()
              + head[2:].tobytes() + v2[12:140] + u32_sizes + payload)
    for buf in (v1, v2_u32):
        assert hf.is_container(buf) and jhf.is_container(buf)
        np.testing.assert_array_equal(hf.huff_decompress(buf, device="cpu"),
                                      data)
        np.testing.assert_array_equal(
            jhf.huff_decompress(buf, backend="numpy"), data)
    with pytest.raises(sprintz_tpu_torch.CorruptStreamError):
        hf.huff_decompress(v2[:-1], device="cpu")


def test_is_container_strictness(rng):
    for n in (0, 1, 100, 10_007):
        data = rng.integers(0, 17, n).astype(np.uint8)
        for cs in (128, 4096):
            buf = hf.huff_compress(data, cs, device="cpu")
            bad = [buf[:-1], buf + b"\0", buf[:11], b"",
                   buf[:6] + b"\x08\x00" + buf[8:],  # unknown flag
                   buf[:8] + b"\x07\0\0\0" + buf[12:]]  # wrong nchunks
            for b in [buf] + bad:
                assert hf.is_container(b) == jhf.is_container(b)
            assert hf.is_container(buf)
            assert not any(hf.is_container(b) for b in bad[:5])


@pytest.mark.parametrize("codec", ["delta", "xff"])
@pytest.mark.parametrize("elem_sz,ndims", [(1, 7), (2, 5)])
def test_huf_codec_matches_jax(rng, codec, elem_sz, ndims):
    """+Huf bytes equal the JAX package's, and each decodes the other's,
    on a smooth stream (Huffman wins: a container) and a random one (it
    does not: the plain stream ships verbatim)."""
    dt = np.uint8 if elem_sz == 1 else np.uint16
    smooth = np.cumsum(rng.integers(-2, 3, (3000, ndims)), axis=0).astype(dt)
    noise = rng.integers(0, 256 ** elem_sz, (400, ndims)).astype(dt)
    port = sprintz_tpu_torch.SprintzCodec(codec, elem_sz, entropy="huffman",
                                          device="cpu")
    ref = sprintz_tpu.SprintzCodec(codec, elem_sz, entropy="huffman")
    plain = sprintz_tpu_torch.SprintzCodec(codec, elem_sz, device="cpu")
    for x, container in ((smooth, True), (noise, False)):
        got = port.compress(x)
        assert got == ref.compress(x)
        assert hf.is_container(got) == container
        if not container:  # the zero-overhead escape
            assert got == plain.compress(x)
        np.testing.assert_array_equal(port.decompress(got), x.reshape(-1))
        np.testing.assert_array_equal(ref.decompress(got), x.reshape(-1))


def test_huffman_wrappers_check_their_inputs():
    t = hf.build_table(np.arange(10, dtype=np.uint8))
    codes, lengths = hf.encode_table(t, "cpu")
    with pytest.raises(ValueError):
        hk.encode_chunks(torch.zeros(0, dtype=torch.uint8), codes, lengths, 8)
    with pytest.raises(TypeError):
        hk.encode_chunks(torch.zeros(4, dtype=torch.int32), codes, lengths, 8)
    limits, adj, perm = hf.decode_tables(t, "cpu")
    data = torch.zeros(16, dtype=torch.uint8)
    offs = torch.zeros(2, dtype=torch.int64)
    sizes = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="fit"):
        hk.decode_chunks(data, offs, sizes, limits, adj, perm, 4, 9)
    with pytest.raises(ValueError):
        hk.decode_chunks(data, offs, sizes[:1], limits, adj, perm, 4, 8)
    with pytest.raises(ValueError, match="u16"):
        hf.huff_compress(b"abc", chunk_symbols=1 << 16, device="cpu")
