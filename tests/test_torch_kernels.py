"""Decode kernels of the PyTorch port (K1 unpack_zz, K2 prefix_finish and
their pipeline) against the JAX package's Pallas kernels, which run here in
interpret mode. On a CPU tensor each wrapper runs its plain PyTorch
version, so these tests hold the plain versions, the arithmetic the CUDA
kernels are compared with on the card, to the TPU kernels. Every
comparison is bit-exact: the codec is lossless."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sprintz_tpu.ops import pallas_decode as jpd
from sprintz_tpu_torch.ops import decode_kernels as dk


def legal_widths(eb: int) -> list[int]:
    """Widths block_widths_rowmajor can emit: 7 promotes to 8, and for u16
    8 + 7 = 15 promotes to 16."""
    return [w for w in range(eb + 1) if w not in (7, 15)]


def edge_widths(rng, nb: int, ndims: int, eb: int) -> np.ndarray:
    """Blocks of all-0 widths, all-eb widths, every legal width in turn,
    and random legal widths. For u16 the cycle puts 16-bit fields at odd
    bit offsets, so shifted fields reach 23 bits and span 3 bytes."""
    legal = np.array(legal_widths(eb))
    w = legal[rng.integers(0, len(legal), (nb, ndims))]
    w[0] = 0
    w[1] = eb
    w[2] = legal[np.arange(ndims) % len(legal)]
    if eb == 16:
        w[3] = np.where(np.arange(ndims) % 2 == 0, 3, 16)  # off & 7 == 3, 7
        w[4] = np.where(np.arange(ndims) == 0, 1, 16)  # off & 7 == 1
    return w


def payload(rng, widths: np.ndarray, eb: int):
    """Random zigzag fields within their widths, packed row-major LSB first
    (the stream's own layout, written with Python integers) ->
    (fields (nb, 8, D) int64, dense (nb, 8, D * eb / 8) uint8)."""
    nb, ndims = widths.shape
    fields = rng.integers(0, 1 << 30, (nb, 8, ndims)) % (
        1 << widths.astype(np.int64))[:, None, :]
    maxb = ndims * eb // 8
    dense = np.zeros((nb, 8, maxb), np.uint8)
    for b in range(nb):
        sh = np.concatenate([[0], np.cumsum(widths[b])[:-1]])
        for r in range(8):
            v = sum(int(f) << int(s) for f, s in zip(fields[b, r], sh))
            dense[b, r] = np.frombuffer(v.to_bytes(maxb, "little"), np.uint8)
    return fields, dense


def exclusive(tots: np.ndarray) -> np.ndarray:
    """Exclusive scan of (ntiles, 1, D) tile totals over the tiles, in
    wrapping int32: the JAX pipeline's step after its K1
    (``pallas_decode.py:207``), which the port's K1 returns."""
    excl = np.cumsum(tots.astype(np.int64), axis=0) - tots
    return ((excl + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)


def jax_unpack_zz(dense, widths, eb):
    """The JAX kernel at the port's tile (nb a multiple of it), then its
    cumsum of the tile totals: (biased deltas, tile offsets)."""
    bz, tots = jpd.unpack_zz(jnp.asarray(dense), jnp.asarray(widths, jnp.int32),
                             eb, tile=dk.TILE_BLOCKS, interpret=True)
    return np.asarray(bz), exclusive(np.asarray(tots))


def port_unpack_zz(dense, widths, eb):
    """The port's K1 with the header walk's u8 widths."""
    bz, toff = dk.unpack_zz(torch.from_numpy(dense),
                            torch.from_numpy(widths.astype(np.uint8)), eb)
    return dk.widen(bz).numpy(), toff.numpy()


@pytest.mark.parametrize("eb,ndims,nb", [(8, 9, 64), (16, 17, 64)])
def test_unpack_zz_matches_pallas(rng, eb, ndims, nb):
    widths = edge_widths(rng, nb, ndims, eb)
    fields, dense = payload(rng, widths, eb)
    bz, toff = port_unpack_zz(dense, widths, eb)
    want_bz, want_toff = jax_unpack_zz(dense, widths, eb)
    np.testing.assert_array_equal(bz, want_bz.astype(np.int64))
    np.testing.assert_array_equal(toff, want_toff)
    # and both are the zigzag decode of the fields that were packed
    deltas = (fields >> 1) ^ -(fields & 1)
    np.testing.assert_array_equal(bz, deltas + (1 << (eb - 1)))


def test_unpack_zz_maxb_below_row_width(rng):
    """The JAX gather may shrink MAXB to the widest row's byte count
    (rounded to a power of two), below D * elem_sz; bytes past MAXB read
    as zero."""
    eb, ndims, nb = 8, 64, 32
    widths = rng.choice([0, 1, 2, 3], (nb, ndims))
    widths[0] = 3  # the widest row: 24 bytes
    _, dense = payload(rng, widths, eb)
    dense = np.ascontiguousarray(dense[:, :, :32])
    assert dense.shape[2] < ndims
    bz, toff = port_unpack_zz(dense, widths, eb)
    want_bz, want_toff = jax_unpack_zz(dense, widths, eb)
    np.testing.assert_array_equal(bz, want_bz.astype(np.int64))
    np.testing.assert_array_equal(toff, want_toff)


def test_unpack_zz_ragged_tile(rng):
    """nb not a multiple of the tile: the last tile is short, and the
    offsets are those of totals over each tile's own blocks."""
    eb, ndims, nb, tile = 16, 5, 41, dk.TILE_BLOCKS
    widths = edge_widths(rng, nb, ndims, eb)
    fields, dense = payload(rng, widths, eb)
    bz, toff = port_unpack_zz(dense, widths, eb)
    deltas = (fields >> 1) ^ -(fields & 1)
    np.testing.assert_array_equal(bz, deltas + (1 << (eb - 1)))
    want = np.stack([deltas[i:i + tile].sum(axis=(0, 1))
                     for i in range(0, nb, tile)])[:, None, :]
    np.testing.assert_array_equal(toff, exclusive(want))


def biased_deltas(rng, rows, ndims, eb):
    """Deltas over the whole signed range, the extremes included."""
    half = 1 << (eb - 1)
    deltas = rng.integers(-half, half, (rows, ndims))
    deltas[::7, 0] = -half
    deltas[3::7, 0] = half - 1
    deltas[:, -1] = -half  # a dim that wraps every row
    return deltas


def as_narrow(x: np.ndarray, eb: int) -> torch.Tensor:
    return dk.narrow(torch.from_numpy(x.astype(np.int32)), eb)


@pytest.mark.parametrize("eb,ndims", [(8, 64), (16, 5)])
def test_prefix_finish_matches_pallas(rng, eb, ndims):
    rows, tile = 1024, dk.TILE_ROWS
    deltas = biased_deltas(rng, rows, ndims, eb)
    tots = deltas.reshape(-1, tile, ndims).sum(axis=1)
    toff = (np.cumsum(tots, axis=0) - tots).astype(np.int32)[:, None, :]
    bz = deltas + (1 << (eb - 1))
    got = dk.prefix_finish(as_narrow(bz, eb), torch.from_numpy(toff), eb)
    want = np.asarray(jpd.prefix_finish(
        jnp.asarray(bz, jnp.uint8 if eb == 8 else jnp.uint16),
        jnp.asarray(toff), eb, tile, interpret=True))
    np.testing.assert_array_equal(dk.widen(got).numpy(), want)
    np.testing.assert_array_equal(want, np.cumsum(deltas, axis=0) % (1 << eb))


def test_prefix_finish_ragged_rows(rng):
    """rows not a multiple of the tile (the JAX kernel asserts it is; the
    port masks the short last tile)."""
    eb, ndims, rows, tile = 16, 3, 1000, dk.TILE_ROWS
    deltas = biased_deltas(rng, rows, ndims, eb)
    pad = np.zeros((-rows % tile, ndims), np.int64)
    tots = np.concatenate([deltas, pad]).reshape(-1, tile, ndims).sum(axis=1)
    toff = (np.cumsum(tots, axis=0) - tots).astype(np.int32)[:, None, :]
    got = dk.prefix_finish(as_narrow(deltas + (1 << (eb - 1)), eb),
                           torch.from_numpy(toff), eb)
    np.testing.assert_array_equal(dk.widen(got).numpy(),
                                  np.cumsum(deltas, axis=0) % (1 << eb))


def test_prefix_finish_checks_offsets_shape():
    bz = torch.zeros((300, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="tile_offsets"):
        dk.prefix_finish(bz, torch.zeros((1, 1, 4), dtype=torch.int32), 8)


@pytest.mark.parametrize("eb", [8, 16])
def test_delta_forecaster_matches_jax(rng, eb):
    """delta_encode and the plain delta_decode (an integer cumsum, where the
    JAX package uses a bf16 byte-plane matmul) against the JAX functions,
    with steps over the whole range so the running sum wraps."""
    from sprintz_tpu.models import forecasters as jfc
    from sprintz_tpu_torch.models import forecasters as fc

    vals = rng.integers(0, 1 << eb, (777, 6)).astype(np.int32)
    vals[100:140] = vals[99]  # a stretch of zero deltas
    errs = fc.delta_encode(torch.from_numpy(vals), eb)
    want = np.asarray(jfc.delta_encode(jnp.asarray(vals), eb))
    np.testing.assert_array_equal(errs.numpy(), want)
    back = fc.delta_decode(errs, eb)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jfc.delta_decode(jnp.asarray(want), eb)))
    np.testing.assert_array_equal(back.numpy(), vals)


def encoded(rng, eb, ndims, nb):
    """A random walk, delta-encoded and packed by the port's plain path."""
    from sprintz_tpu_torch.encoder import encode_device

    vals = (np.cumsum(rng.integers(-40, 41, (nb * 8, ndims)), axis=0)
            % (1 << eb))
    rows = torch.from_numpy(vals.astype(np.int32))
    widths, _, dense, _ = encode_device(rows, eb // 8)
    return vals, dense, widths.to(torch.uint8)  # u8, as the header walk's


@pytest.mark.parametrize("eb,ndims,nb", [(8, 64, 128), (16, 33, 96)])
def test_decode_delta_contiguous_matches_pallas(rng, eb, ndims, nb):
    vals, dense, widths = encoded(rng, eb, ndims, nb)
    got = dk.widen(dk.decode_delta_contiguous(dense, widths, eb)).numpy()
    want = np.asarray(jpd.decode_delta_contiguous(
        jnp.asarray(dense.numpy()), jnp.asarray(widths.numpy(), jnp.int32), eb,
        interpret=True))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(got, vals)


@pytest.mark.parametrize("eb,ndims,nb", [(8, 129, 41), (16, 6, 100)])
def test_decode_delta_contiguous_ragged(rng, eb, ndims, nb):
    """nb not a multiple of the 32-block tile."""
    vals, dense, widths = encoded(rng, eb, ndims, nb)
    got = dk.decode_delta_contiguous(dense, widths, eb)
    np.testing.assert_array_equal(dk.widen(got).numpy(), vals)


def test_wrappers_check_their_inputs():
    dense = torch.zeros((4, 8, 8), dtype=torch.uint8)
    widths = torch.zeros((4, 8), dtype=torch.uint8)
    with pytest.raises(TypeError):
        dk.unpack_zz(dense.to(torch.int32), widths, 8)
    with pytest.raises(TypeError):
        dk.unpack_zz(dense, widths.to(torch.int64), 8)
    with pytest.raises(ValueError):
        dk.unpack_zz(dense, widths[:3], 8)
    with pytest.raises(ValueError):
        dk.unpack_zz(dense.transpose(1, 2), widths, 8)
    with pytest.raises(ValueError):
        dk.unpack_zz(dense, widths, 12)
