"""The port's sharded decode from stream bytes (``shard.dp_decompress``) on
meshes of 1 to 8 CPU shards: delta and xff, row-major and lowdim, u8 and
u16, with RLE runs and tails, without and with a checkpoint sidecar (FIRE's
shards then start at the sidecar's checkpoints, each from its recorded
state; with fewer checkpoints than shards the last shards are empty);
every result equals the input, and at a few cases the JAX package's
``dp_decompress`` on its 8-device mesh. Also the sharded output mode and a
sidecar that does not fit its stream."""

import functools

import numpy as np
import pytest

import jax

from sprintz_tpu import checkpoint as jc
from sprintz_tpu.parallel import shard as jshard
from sprintz_tpu_torch import checkpoint, encoder
from sprintz_tpu_torch.errors import CorruptStreamError
from sprintz_tpu_torch.parallel import shard

# (codec, elem_sz, ndims): row-major and lowdim
LAYOUTS = [(codec, es, nd) for codec in ("delta", "xff")
           for es, nd in ((1, 9), (2, 5), (1, 4), (1, 3), (2, 2), (2, 1))]


def cpu_mesh(n: int) -> shard.Mesh:
    return shard.make_mesh(devices=["cpu"] * n)


@functools.cache
def stream_of(codec: str, es: int, nd: int, rows: int = 1500,
              every: int | None = None):
    """(flat, stream[, sidecar]) from the port's encoder (whose bytes are
    the JAX package's, held elsewhere): a walk with a long constant
    stretch (runs) and a tail."""
    rng = np.random.default_rng([es, nd, rows, codec == "xff"])
    dt = np.uint8 if es == 1 else np.uint16
    x = (np.cumsum(rng.integers(-5, 6, (rows, nd)), axis=0)
         % (1 << (8 * es))).astype(dt)
    x[rows // 3: rows // 3 + 400] = x[rows // 3 - 1]
    flat = x.reshape(-1)[: rows * nd - 1]
    if every is None:
        return flat, encoder.compress(flat, nd, codec, device="cpu")
    buf, sc = checkpoint.compress_with_sidecar(flat, nd, codec, every,
                                               device="cpu")
    return flat, buf, sc


@pytest.mark.parametrize("nshards", [1, 3, 8])
@pytest.mark.parametrize("codec,es,nd", LAYOUTS)
def test_dp_decompress_equals_input(nshards, codec, es, nd):
    flat, buf = stream_of(codec, es, nd)
    out = shard.dp_decompress(cpu_mesh(nshards), buf, codec, es)
    assert out.dtype == flat.dtype
    np.testing.assert_array_equal(out, flat)


@pytest.mark.parametrize("nshards", [2, 8])
@pytest.mark.parametrize("every", [2, 16])
@pytest.mark.parametrize("codec,es,nd", [("xff", 1, 9), ("xff", 2, 2),
                                         ("delta", 1, 9), ("xff", 1, 4)])
def test_dp_decompress_sidecar_equals_input(nshards, every, codec, es, nd):
    """every 16: 6-7 checkpoints (fewer than 8 shards: empty shards);
    every 2: a checkpoint every 4 blocks, several a shard."""
    flat, buf, sc = stream_of(codec, es, nd, every=every)
    mesh = cpu_mesh(nshards)
    np.testing.assert_array_equal(
        shard.dp_decompress(mesh, buf, codec, es, sidecar=sc), flat)
    vals, spans, total_rows, tail = shard.dp_decompress(
        mesh, buf, codec, es, sidecar=sc, out="sharded")
    assert int(spans.sum()) == total_rows
    if codec == "xff" and every == 16 and nshards == 8:
        assert (spans == 0).any()  # fewer checkpoints than shards
    body = shard.gather_rows(mesh, vals).reshape(-1)
    np.testing.assert_array_equal(np.concatenate([body, tail]), flat)


@pytest.fixture(scope="module")
def jmesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual JAX devices of tests/conftest.py")
    return jshard.make_mesh(8)


@pytest.mark.parametrize("codec,es,nd,every", [
    ("delta", 1, 9, None), ("xff", 2, 5, None), ("delta", 1, 4, None),
    ("xff", 1, 9, 16)])
def test_dp_decompress_equals_jax_dp_decompress(jmesh8, codec, es, nd, every):
    got = stream_of(codec, es, nd, every=every)
    flat, buf = got[:2]
    sc = got[2] if every else None
    jsc = None if sc is None else jc.Sidecar.from_bytes(sc.to_bytes())
    want = jshard.dp_decompress(jmesh8, buf, codec=codec, elem_sz=es,
                                sidecar=jsc)
    out = shard.dp_decompress(cpu_mesh(8), buf, codec, es, sidecar=sc)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, flat)


@pytest.mark.parametrize("nd,rows", [(9, 24), (4, 40)])
def test_more_shards_than_blocks_and_verbatim(nd, rows):
    """3 (row-major) or 5 (lowdim) blocks over 8 shards, so the last spans
    are empty, and a verbatim stream."""
    mesh = cpu_mesh(8)
    rng = np.random.default_rng(2)
    for codec in ("delta", "xff"):
        flat = rng.integers(0, 256, rows * nd + 5).astype(np.uint8)
        job = shard.index_stream(mesh, encoder.compress(
            flat, nd, codec, device="cpu"), codec, 1)
        assert (job.spans == 0).any()
        buf = encoder.compress(flat, nd, codec, device="cpu")
        np.testing.assert_array_equal(
            shard.dp_decompress(mesh, buf, codec, 1), flat)
        short = flat[:50]
        np.testing.assert_array_equal(shard.dp_decompress(
            mesh, encoder.compress(short, nd, codec, device="cpu"), codec, 1),
            short)


def test_inconsistent_sidecar_raises():
    flat, buf, sc = stream_of("xff", 1, 9, every=2)
    sc.row_offsets = sc.row_offsets[::-1].copy()
    try:
        with pytest.raises(CorruptStreamError):
            shard.dp_decompress(cpu_mesh(2), buf, "xff", 1, sidecar=sc)
    finally:
        sc.row_offsets = sc.row_offsets[::-1].copy()
