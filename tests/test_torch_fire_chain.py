"""FIRE's chain primitives in the PyTorch port: ``fire_encode`` and
``fire_decode`` from a carried ``init_state`` with ``final=True`` (the
carry after the last block, which a sharded scan hands to the next shard)
against the JAX package's ``_fire_scan(init_state=..., return_final=True)``,
bit-exact: both coefficients, u8 and u16, D 1, 5 and 64, counters that wrap
inside the stream, and a stream split in two whose chained halves give the
whole. The plain versions run here; the host build of ``csrc/fire.cu``
(``probes/host_build.py``, g++ against a shim of CUDA's names) is held to
them at the same cases."""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sprintz_tpu.models import forecasters as jf
from sprintz_tpu_torch.models import forecasters as fc
from sprintz_tpu_torch.ops import decode_kernels as dk
from sprintz_tpu_torch.probes import host_build as hb

NB = 12  # blocks a case: enough for the counter to move and wrap
CASES = [(eb, nd, trunc) for eb in (8, 16) for nd in (1, 5, 64)
         for trunc in (True, False)]


def chain_case(eb: int, nd: int, trunc: bool):
    """(rows (N, D) int32, a carried (3, D) init whose counter sits near its
    wrap): steep walks, so the counter moves a long way in a few blocks."""
    rng = np.random.default_rng(eb * 1009 + nd * 17 + int(trunc))
    hi = 1 << eb
    steps = rng.integers(-(hi >> 3), (hi >> 3) + 1, (NB * 8, nd))
    steps[: NB * 4] = np.arange(1, nd + 1)[None, :] * (hi >> 4)  # steady slopes
    rows = (np.cumsum(steps, axis=0) % hi).astype(np.int32)
    init = hb.fire_chain_states(rng, eb, nd, 1)[0]
    return rows, init


def jax_scan(x: np.ndarray, eb: int, trunc: bool, decode: bool, init):
    """JAX's scan from ``init`` -> (out (N, D), the final carry (3, D))."""
    n, nd = x.shape
    out, fin = jf._fire_scan(jnp.asarray(x.reshape(n // 8, 8, nd)), eb, trunc,
                             decode, init_state=tuple(jnp.asarray(s) for s in init),
                             return_final=True)
    return np.asarray(out).reshape(n, nd), np.stack([np.asarray(s) for s in fin])


def errs_in(zz: np.ndarray, eb: int) -> torch.Tensor:
    return torch.from_numpy(zz.astype(np.uint8 if eb == 8 else np.int32))


@pytest.mark.parametrize("eb,nd,trunc", CASES)
def test_carries_match_jax(eb, nd, trunc):
    rows, init = chain_case(eb, nd, trunc)
    want_e, want_ef = jax_scan(rows, eb, trunc, False, init)
    errs, fin = fc.fire_encode(torch.from_numpy(rows), eb, trunc,
                               init_state=init, final=True)
    np.testing.assert_array_equal(errs.numpy(), want_e)
    np.testing.assert_array_equal(fin.numpy(), want_ef)
    want_v, want_vf = jax_scan(want_e, eb, trunc, True, init)
    vals, vfin = fc.fire_decode(errs_in(want_e, eb), eb, init, trunc, final=True)
    np.testing.assert_array_equal(dk.widen(vals).numpy(), want_v)
    np.testing.assert_array_equal(vfin.numpy(), want_vf)
    np.testing.assert_array_equal(want_v, rows)
    # the states' encode keeps its carries and gives the same final carry
    e2, carries, fin2 = fc.fire_encode(torch.from_numpy(rows), eb, trunc,
                                       states=True, init_state=init, final=True)
    assert torch.equal(e2, errs) and torch.equal(fin2, fin)
    np.testing.assert_array_equal(carries[0].numpy(), init)
    # the counter wrapped inside the stream: a step of over a quarter of
    # its range between two blocks
    counters = np.concatenate([carries[:, 2].numpy(), fin.numpy()[2:]])
    span = 1 << (16 if eb == 8 else 32)
    assert (np.abs(np.diff(counters.astype(np.int64), axis=0)) > span // 4).any()


@pytest.mark.parametrize("eb,nd,trunc", CASES)
def test_split_stream_chains_to_whole(eb, nd, trunc):
    """Each half scanned once, the second from the first's final carry, as a
    shard scans from its neighbour's: errors, values and final carries equal
    the whole stream's, from the zero state."""
    rows, _ = chain_case(eb, nd, trunc)
    x = torch.from_numpy(rows)
    whole, whole_fin = fc.fire_encode(x, eb, trunc, final=True)
    for cut in (8, 8 * (NB // 2 + 1)):
        e0, f0 = fc.fire_encode(x[:cut], eb, trunc, final=True)
        e1, f1 = fc.fire_encode(x[cut:], eb, trunc, init_state=f0, final=True)
        assert torch.equal(torch.cat([e0, e1]), whole)
        assert torch.equal(f1, whole_fin)
        zz = errs_in(whole.numpy(), eb)
        v0, g0 = fc.fire_decode(zz[:cut], eb, None, trunc, final=True)
        v1, g1 = fc.fire_decode(zz[cut:], eb, g0, trunc, final=True)
        assert torch.equal(dk.widen(torch.cat([v0, v1])), x)
        assert torch.equal(g1, whole_fin)


def test_empty_scan_returns_its_init():
    init = np.array([[3, 4], [-5, 6], [7, -8]], np.int32)
    e, fin = fc.fire_encode(torch.zeros((0, 2), dtype=torch.int32), 8,
                            init_state=init, final=True)
    assert e.shape == (0, 2)
    np.testing.assert_array_equal(fin.numpy(), init)
    v, vfin = fc.fire_decode(torch.zeros((0, 2), dtype=torch.uint8), 8, init,
                             final=True)
    assert v.shape == (0, 2)
    np.testing.assert_array_equal(vfin.numpy(), init)
    with pytest.raises(ValueError, match="init_state"):
        fc.fire_encode(torch.zeros((8, 2), dtype=torch.int32), 8,
                       init_state=np.zeros((3, 3), np.int32))


@pytest.fixture(scope="module")
def fire_library(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the kernels' host build needs it")
    return hb.build_fire(out=tmp_path_factory.mktemp("host"))


@pytest.mark.parametrize("eb,nd,trunc", CASES)
def test_host_built_carries_equal_plain(fire_library, eb, nd, trunc):
    """fire.cu's serial scans with their init and final carries, built on
    the host, against the plain versions at the cases above (from the
    zero, carried and wrapping states; two halves chained)."""
    rows, init = chain_case(eb, nd, trunc)
    x = torch.from_numpy(rows)
    zz = fc.fire_encode_plain(x, eb, trunc, init_state=init)
    zz = zz.to(torch.uint8) if eb == 8 else zz
    hk = hb.HostKernels(fire_library, 2)
    assert hb.check_fire_carries(hk, eb, nd, NB, trunc, x, zz,
                                 torch.from_numpy(init)) is None
