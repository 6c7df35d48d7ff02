"""The lowdim layout's two device passes in the PyTorch port against the
JAX package's, on the CPU: the plain ``encode_lowdim`` (what
``csrc/pack.cu``'s ``encode_lowdim_kernel`` is held to on the card)
against ``sprintz_tpu.encoder._encode_pass(..., lowdim=True)`` for delta
and FIRE (xff), and the plain ``decode_delta_lowdim`` (what
``csrc/decode.cu``'s ``decode_lowdim_kernel`` is held to) against
``sprintz_tpu.decoder._decode_pass(..., "delta", ..., lowdim=True, ...)``.

Every lowdim width (u8 D 1-4, u16 D 1-2), nb from 1 to 4101 (one span of
256 blocks, one block short of 1024 and spans with a ragged last one:
the kernels' spans are 256, 512 or 1024 blocks by width), blocks of
all-zero, all-maximum and every legal width, u16 values that wrap, and a
stream with runs. Inputs are made with numpy from a seed; every
comparison is exact (integers)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sprintz_tpu import decoder as jdec
from sprintz_tpu import encoder as jenc
from sprintz_tpu_torch import decoder
from sprintz_tpu_torch.models import forecasters as fc
from sprintz_tpu_torch.ops import decode_kernels as dk
from sprintz_tpu_torch.ops import pack_kernels as pk
from sprintz_tpu_torch.probes import encode_cases as ec
from sprintz_tpu_torch.probes import unpack_cases as uc

LOWDIM = [(1, 1), (1, 2), (1, 3), (1, 4), (2, 1), (2, 2)]  # (elem_sz, D)
NBS = [1, 256, 1023, 4101]


def rows_of(rng, kind: str, nb: int, ndims: int, elem_sz: int) -> np.ndarray:
    """(nb * 8, D) u8/u16 rows of one family: "edge widths" (every legal
    width, all-zero and all-maximum blocks: ``encode_cases``), "walk", or
    "wrap" (u16 steps that cross 0 and 2^16 - 1 in most rows)."""
    eb = 8 * elem_sz
    if kind == "edge widths":
        return ec.lowdim_rows_case(rng, ndims, elem_sz, nb)[0]
    if kind == "walk":
        x = np.cumsum(rng.integers(-6, 7, (nb * 8, ndims)), axis=0)
    else:  # "wrap": around 0, so most steps wrap
        x = rng.integers(-300, 300, (nb * 8, ndims))
    return (x % (1 << eb)).astype(np.uint8 if elem_sz == 1 else np.uint16)


def jax_encode(rows: np.ndarray, codec: str, elem_sz: int):
    widths, hdr, dense, wsums = jenc._encode_pass(
        jnp.asarray(rows), codec, elem_sz, True)
    return (np.asarray(widths).astype(np.uint8), np.asarray(hdr).astype(np.uint8),
            np.asarray(dense), np.asarray(wsums).astype(np.int32))


def assert_same_pass(got, want):
    for name, g, w in zip(("widths", "hdr", "dense", "wsums"), got, want):
        assert g.dtype == (torch.int32 if name == "wsums" else torch.uint8), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("elem_sz,ndims", LOWDIM)
@pytest.mark.parametrize("nb", NBS)
def test_encode_pass_matches_jax(elem_sz, ndims, nb):
    """Delta from the rows as uploaded: every legal width at each nb."""
    rng = np.random.default_rng(elem_sz * 1009 + ndims * 31 + nb)
    rows = rows_of(rng, "edge widths", nb, ndims, elem_sz)
    got = pk.encode_lowdim(ec.rows_tensor(rows), elem_sz)
    assert_same_pass(got, jax_encode(rows, "delta", elem_sz))


@pytest.mark.parametrize("elem_sz,ndims", LOWDIM)
@pytest.mark.parametrize("kind", ["walk", "wrap"])
def test_encode_pass_streams_match_jax(elem_sz, ndims, kind):
    """Delta on a walk and on values that wrap, over spans of every size."""
    rng = np.random.default_rng(elem_sz * 1009 + ndims * 31 + len(kind))
    rows = rows_of(rng, kind, 4101, ndims, elem_sz)
    got = pk.encode_lowdim(ec.rows_tensor(rows), elem_sz)
    assert_same_pass(got, jax_encode(rows, "delta", elem_sz))


@pytest.mark.parametrize("elem_sz,ndims", LOWDIM)
def test_encode_pass_from_fire_errors_matches_jax(elem_sz, ndims):
    """xff: FIRE's errors (full-precision coefficient) through the plain
    encode pass. The plain FIRE loops over blocks in Python: 33 blocks."""
    rng = np.random.default_rng(elem_sz * 1009 + ndims * 31 + 7)
    rows = rows_of(rng, "wrap", 33, ndims, elem_sz)
    errs = fc.fire_encode(torch.from_numpy(rows.astype(np.int32)), 8 * elem_sz,
                          truncate_coeffs=False)
    got = pk.encode_lowdim(errs, elem_sz, errors=True)
    assert_same_pass(got, jax_encode(rows, "xff", elem_sz))


def jax_decode(dense: np.ndarray, widths: np.ndarray, out_rows: np.ndarray,
               total_rows: int, elem_sz: int) -> np.ndarray:
    return np.asarray(jdec._decode_pass(
        jnp.asarray(dense), jnp.asarray(widths), jnp.asarray(out_rows), "delta",
        elem_sz, True, total_rows))


@pytest.mark.parametrize("elem_sz,ndims", LOWDIM)
@pytest.mark.parametrize("nb,kind", [(1, "random"), (256, "random"),
                                     (1023, "zero widths"), (4101, "random")])
def test_decode_pass_matches_jax(elem_sz, ndims, nb, kind):
    """Sections of every legal width (all-zero and all-maximum blocks) or
    with blocks of width 0 -> the values, against JAX's delta pass."""
    eb = 8 * elem_sz
    rng = np.random.default_rng(eb * 7919 + ndims * 31 + nb + 3)
    dense, widths, _ = uc.lowdim_case(rng, eb, ndims, nb, kind)
    got = dk.decode_delta_lowdim(torch.from_numpy(dense), torch.from_numpy(widths), eb)
    want = jax_decode(dense, widths, np.arange(nb) * 8, nb * 8, elem_sz)
    assert got.dtype == dk.narrow_dtype(eb)
    np.testing.assert_array_equal(dk.widen(got).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("elem_sz,ndims", LOWDIM)
def test_decode_pass_with_runs_matches_jax(elem_sz, ndims):
    """A stream with runs: the data blocks placed on the block timeline
    (run blocks of width 0, as ``decoder.decode_device`` places them)
    decode to JAX's values."""
    eb = 8 * elem_sz
    rng = np.random.default_rng(eb * 7919 + ndims * 31 + 11)
    nb = 700
    dense, widths, _ = uc.lowdim_case(rng, eb, ndims, nb, "random")
    # runs of up to 40 blocks before about 30% of the data blocks
    gaps = rng.integers(0, 41, nb) * (rng.random(nb) < 0.3)
    out_rows = (np.cumsum(gaps) + np.arange(nb)) * 8
    total_rows = int(out_rows[-1]) + 8
    got = decoder.decode_device(
        torch.from_numpy(dense), torch.from_numpy(widths),
        torch.from_numpy(out_rows), total_rows, elem_sz, "delta", lowdim=True)
    want = jax_decode(dense, widths, out_rows, total_rows, elem_sz)
    np.testing.assert_array_equal(dk.widen(got).numpy(), want.astype(np.int64))
    # the encode pass of the values finds every run block again
    _, _, _, wsums = pk.encode_lowdim(ec.rows_tensor(want), elem_sz)
    runs = np.setdiff1d(np.arange(total_rows // 8), out_rows // 8)
    assert runs.size and not wsums.numpy()[runs].any()
