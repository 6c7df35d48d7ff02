"""The port's sharded encode (``sprintz_tpu_torch.parallel.shard``) on meshes
of 1 to 8 CPU shards, against the JAX package: ``dp_compress`` writes the
JAX package's single-device bytes (``sprintz_tpu.encoder.compress``) for
delta and xff, u8 D 5 / 8 / 64 and u16 D 3 / 40, at lengths that are not a
multiple of shards x 8 rows, with a verbatim tail and RLE runs across shard
boundaries; ``dp_encode``'s sizes and exclusive offsets equal the JAX
package's ``dp_encode`` on its 8-device mesh; the encode -> decode step
and the dry run give their input back. At the lowdim ndims the port's
``dp_compress`` raises, where the JAX package's writes a row-major stream
that its own ``decompress`` reads wrong (pinned here). Each case's JAX
bytes are computed once."""

import functools

import numpy as np
import pytest
import torch

import jax

from sprintz_tpu import decoder as jdecoder
from sprintz_tpu import encoder as jencoder
from sprintz_tpu.parallel import shard as jshard
from sprintz_tpu_torch import encoder
from sprintz_tpu_torch.parallel import dryrun, shard

MESHES = [1, 2, 3, 8]
# (codec, elem_sz, ndims, rows): rows are not a multiple of 8 x shards,
# and every stream ends in a tail shorter than a row
CASES = [(codec, es, nd, rows) for codec in ("delta", "xff")
         for es, nd, rows in ((1, 5, 803), (1, 8, 610), (1, 64, 101),
                              (2, 3, 707), (2, 40, 93))]


def cpu_mesh(n: int) -> shard.Mesh:
    return shard.make_mesh(devices=["cpu"] * n)


@functools.cache
def case_data(codec: str, es: int, nd: int, rows: int):
    """(flat input, the JAX package's single-device stream): a walk with a
    constant stretch in the middle (a run that crosses shard boundaries at
    every mesh size here) and a tail of nd - 2 elements."""
    rng = np.random.default_rng([CASES.index((codec, es, nd, rows)), 7])
    dt = np.uint8 if es == 1 else np.uint16
    x = (np.cumsum(rng.integers(-6, 7, (rows, nd)), axis=0)
         % (1 << (8 * es))).astype(dt)
    x[rows // 4: rows // 4 + rows // 2] = x[rows // 4 - 1]
    flat = x.reshape(-1)[: rows * nd - 2]
    return flat, jencoder.compress(flat, nd, codec=codec)


@pytest.mark.parametrize("nshards", MESHES)
@pytest.mark.parametrize("codec,es,nd,rows", CASES)
def test_dp_compress_equals_jax_single_device(nshards, codec, es, nd, rows):
    flat, jbuf = case_data(codec, es, nd, rows)
    got = shard.dp_compress(cpu_mesh(nshards), flat, nd, codec)
    assert got == jbuf
    assert got == encoder.compress(flat, nd, codec, device="cpu")


@pytest.mark.parametrize("codec", ["delta", "xff"])
def test_dp_compress_short_streams(codec):
    """A verbatim stream, and one with groups but no whole block over the
    mesh's shards."""
    mesh = cpu_mesh(3)
    rng = np.random.default_rng(5)
    for nd, n in ((9, 100), (20, 150), (9, 9 * 8 * 2 + 3)):
        flat = rng.integers(0, 256, n).astype(np.uint8)
        assert shard.dp_compress(mesh, flat, nd, codec) == \
            encoder.compress(flat, nd, codec, device="cpu")


@pytest.fixture(scope="module")
def jmesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual JAX devices of tests/conftest.py")
    return jshard.make_mesh(8)


@pytest.mark.parametrize("codec,es,nd", [("delta", 1, 8), ("xff", 2, 6)])
def test_dp_encode_sizes_and_offsets_equal_jax(jmesh8, codec, es, nd):
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 60, (8 * 8 * 5, nd)).astype(np.int32)
    rows[40:200] = 3  # zero blocks in some shards
    _, _, _, jsizes, joffsets = jshard.dp_encode(jmesh8, rows, es, codec)
    enc = shard.dp_encode(cpu_mesh(8), rows, es, codec)
    np.testing.assert_array_equal(enc.sizes, np.asarray(jsizes).reshape(-1))
    np.testing.assert_array_equal(enc.offsets,
                                  np.asarray(joffsets).reshape(-1))
    np.testing.assert_array_equal(
        enc.offsets, np.concatenate([[0], np.cumsum(enc.sizes)[:-1]]))


@pytest.mark.parametrize("codec", ["delta", "xff"])
@pytest.mark.parametrize("nshards", [1, 4, 8])
def test_training_step_roundtrip(codec, nshards):
    mesh = cpu_mesh(nshards)
    rng = np.random.default_rng(3)
    for es, nd in ((1, 12), (2, 5)):
        rows = (np.cumsum(rng.integers(-3, 4, (nshards * 8 * 6, nd)), axis=0)
                % (1 << (8 * es))).astype(np.int32)
        decoded, nbytes = shard.training_step(mesh, rows, es, codec)
        np.testing.assert_array_equal(shard.gather_rows(mesh, decoded), rows)
        assert nbytes > 0


def test_dryrun_multichip_on_cpu_shards():
    dryrun.dryrun_multichip(8, ["cpu"] * 8)


@pytest.mark.parametrize("es,nd", [(1, 1), (1, 4), (2, 1), (2, 2)])
def test_dp_compress_refuses_lowdim(es, nd):
    dt = np.uint8 if es == 1 else np.uint16
    with pytest.raises(ValueError, match="lowdim"):
        shard.dp_compress(cpu_mesh(2), np.zeros(4096 * nd, dt), nd)


def test_jax_dp_compress_lowdim_fault_pinned(jmesh8):
    """The JAX package's dp_compress packs a u8 d4 walk row-major; its
    decompress reads a d4 stream as lowdim and returns other values,
    raising nothing. The port refuses to write that stream (above) and its
    single-device stream round-trips."""
    rng = np.random.default_rng(0)
    flat = (np.cumsum(rng.integers(-6, 7, (1024, 4)), axis=0) % 256).astype(
        np.uint8).reshape(-1)
    bad = jshard.dp_compress(jmesh8, flat, 4, codec="delta")
    assert bad != jencoder.compress(flat, 4, codec="delta")
    assert not np.array_equal(jdecoder.decompress(bad, "delta", 1), flat)
    good = encoder.compress(flat, 4, "delta", device="cpu")
    assert good == jencoder.compress(flat, 4, codec="delta")


def test_make_mesh():
    mesh = shard.make_mesh(3, ["cpu"] * 8)
    assert mesh.size == 3 and mesh.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        shard.make_mesh(9, ["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            shard.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            dryrun.dryrun_multichip(1)


@pytest.mark.parametrize("nshards", [1, 3])
def test_gather_dense_compact_equals_dense(nshards):
    """The bucketed gather gives every byte the assembler reads (a block's
    ceil(sum(widths) / 8) bytes a row), and its buckets move about the
    payload's bytes, well under the dense tensor's."""
    rng = np.random.default_rng(9)
    seg = rng.integers(-4, 5, (nshards * 8 * 64, 64))
    seg[len(seg) // 3: len(seg) // 2] = 0  # zero-width blocks
    rows = (np.cumsum(seg, axis=0) % 256).astype(np.int32)
    mesh = cpu_mesh(nshards)
    enc = shard.dp_encode(mesh, rows, 1, "delta")
    widths, hdr, dense = shard.download_encoded(mesh, enc, 1)
    full = np.concatenate([enc.dense[k].numpy() for k in range(nshards)])
    np.testing.assert_array_equal(
        widths, np.concatenate([enc.widths[k].numpy() for k in range(nshards)]))
    rb = (widths.sum(axis=1) + 7) // 8
    for b in range(full.shape[0]):
        np.testing.assert_array_equal(dense[b, :, :rb[b]], full[b, :, :rb[b]])
    moved = int((np.minimum((rb + 7) // 8 * 8, full.shape[2]) * 8).sum())
    assert moved <= int((rb * 8).sum()) + 8 * 8 * full.shape[0]
    assert moved < full.nbytes / 1.7
