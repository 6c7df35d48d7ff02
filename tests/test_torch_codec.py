"""The PyTorch port's host-side pieces against the JAX package: bit math,
block widths, the emission planner, the entry points' refusals, the
kernel build, and the port's import hygiene."""

import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sprintz_tpu import planner as jplanner
from sprintz_tpu.ops import bitmath as jbm
from sprintz_tpu_torch import SprintzCodec, compress, decompress
from sprintz_tpu_torch import planner
from sprintz_tpu_torch.ops import _build
from sprintz_tpu_torch.ops import bitmath as bm
from sprintz_tpu_torch.ops import decode_kernels as dk

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("eb", [8, 16])
def test_bitmath_exhaustive(eb):
    u = np.arange(1 << eb, dtype=np.int32)
    t, j = torch.from_numpy(u), jnp.asarray(u)
    signed = u - (1 << (eb - 1))  # every signed value of eb bits
    ts, js = torch.from_numpy(signed), jnp.asarray(signed)
    pairs = [
        (bm.zigzag_encode(ts, eb), jbm.zigzag_encode(js, eb)),
        (bm.zigzag_decode(t, eb), jbm.zigzag_decode(j, eb)),
        (bm.sign_extend(t, eb), jbm.sign_extend(j, eb)),
        (bm.bit_length(t, eb), jbm.bit_length(j, eb)),
        (bm.block_widths_rowmajor(t, eb // 8),
         jbm.block_widths_rowmajor(j, eb // 8)),
    ]
    w = bm.block_widths_rowmajor(t, eb // 8)
    pairs += [(bm.header_value(w, eb), jbm.header_value(jnp.asarray(w), eb)),
              (bm.header_to_width(bm.header_value(w, eb), eb), w.numpy())]
    for i, (got, want) in enumerate(pairs):
        assert got.dtype == torch.int32, i
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"pair {i}")
    np.testing.assert_array_equal(
        bm.zigzag_decode(bm.zigzag_encode(ts, eb), eb).numpy(), signed)


def edge_values(eb: int) -> np.ndarray:
    """0, 2^k - 1, 2^k and 2^k + 1 for every k below eb, and the top."""
    p = 1 << np.arange(eb)
    v = np.concatenate([[0, (1 << eb) - 1], p - 1, p, p + 1])
    return np.unique(v[v < (1 << eb)])


@pytest.mark.parametrize("eb", [8, 16])
def test_block_widths_from_max_equal_widths_from_or(rng, eb):
    """torch has no bitwise-OR reduction, so the port takes widths from the
    block's max. Every pair of edge values (as a block's two nonzero rows),
    every u8 pair outright, and random blocks give the same widths and the
    same zero flags as the OR."""
    if eb == 8:
        v = np.arange(256)
    else:
        v = np.concatenate([edge_values(16), rng.integers(0, 1 << 16, 40)])
    a, b = np.meshgrid(v, v)
    blocks = np.zeros((a.size, 8), np.int32)
    blocks[:, 0], blocks[:, 5] = a.reshape(-1), b.reshape(-1)
    rand = rng.integers(0, 1 << eb, (4096, 8)) >> rng.integers(0, eb, (4096, 1))
    blocks = np.concatenate([blocks, rand.astype(np.int32)])
    ormask = np.bitwise_or.reduce(blocks, axis=1)
    got = bm.block_widths_rowmajor(torch.from_numpy(blocks).amax(dim=1),
                                   eb // 8).numpy()
    want = np.asarray(jbm.block_widths_rowmajor(jnp.asarray(ormask), eb // 8))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got == 0, ormask == 0)


def plan_tuple(p):
    return (p.kinds.tolist(), p.values.tolist(), p.ngroups,
            p.consumed_blocks, p.remaining_elems)


@pytest.mark.parametrize("density", [0.0, 0.1, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("ndims", [1, 5, 64])
def test_build_plan_matches_jax(rng, density, ndims):
    """Against the JAX planner with delta's strict run comparator."""
    for nb in (0, 1, 2, 3, 17, 300):
        for extra in (0, 3, 8 * ndims + 1):
            n = nb * 8 * ndims + extra
            flags = rng.random(n // (8 * ndims)) < density
            got = planner.build_plan(flags, n, ndims)
            want = jplanner._build_plan_py(flags, n, ndims, False)
            assert plan_tuple(got) == plan_tuple(want), (nb, extra)


def test_build_plan_run_cap():
    """A 70 000-block zero run passes the 0x7FFF run cap twice; after each
    cap a run slot closes and the group respawns."""
    ndims, nb = 5, 70_001
    flags = np.ones(nb, bool)
    flags[0] = False
    n = nb * 8 * ndims + 7
    got = planner.build_plan(flags, n, ndims)
    want = jplanner._build_plan_py(flags, n, ndims, False)
    assert plan_tuple(got) == plan_tuple(want)
    runs = got.values[got.kinds == planner.KIND_RUN]
    assert runs.max() == planner.MAX_RUN_NBLOCKS
    assert (runs == planner.MAX_RUN_NBLOCKS).sum() >= 2


def test_headers_pack_roundtrip(rng):
    for hdr_bits, ndims in ((3, 5), (4, 17), (3, 64)):
        fields = rng.integers(0, 1 << hdr_bits, (6, ndims)).astype(np.uint8)
        packed = planner.pack_headers(fields, hdr_bits)
        np.testing.assert_array_equal(
            packed, jplanner.pack_headers(fields, hdr_bits))
        np.testing.assert_array_equal(
            planner.unpack_headers(packed, 3, ndims, hdr_bits), fields)


def test_outside_the_slice_raises():
    x = np.zeros((64, 9), np.uint8)
    codec = SprintzCodec("xff", entropy="huffman", device="cpu")
    # sidecars are in the port now: the seekable stream is compress's
    stream, sidecar = codec.compress_seekable(x)
    assert stream == codec.compress(x)
    np.testing.assert_array_equal(codec.decompress(stream, sidecar=sidecar),
                                  x.reshape(-1))
    # so are batches: each stream's bytes are its own compress's
    bufs = codec.compress_batch([x, x])
    assert bufs == [codec.compress(x)] * 2
    for out in codec.decompress_batch(bufs):
        np.testing.assert_array_equal(out, x.reshape(-1))
    for out in SprintzCodec("xff", device="cpu").decompress_batch(
            [compress(x, codec="xff", device="cpu")] * 2):
        np.testing.assert_array_equal(out, x.reshape(-1))
    # a d4 stream made by the JAX package (the lowdim layout) decodes, and
    # the port makes the same bytes
    from sprintz_tpu import encoder as jenc

    x4 = np.arange(400, dtype=np.uint8)
    lowdim = jenc.compress(x4, 4)
    np.testing.assert_array_equal(decompress(lowdim, device="cpu"), x4)
    assert compress(x4.reshape(-1, 4), device="cpu") == lowdim


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    x = np.zeros((64, 9), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        compress(x)
    with pytest.raises(RuntimeError, match="CUDA"):
        decompress(compress(x, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        SprintzCodec().compress(x)


def test_no_fallback_off_cpu():
    """A wrapper given a tensor on neither the CPU nor CUDA raises; it does
    not run its plain version."""
    dense = torch.zeros((4, 8, 8), dtype=torch.uint8, device="meta")
    widths = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        dk.unpack_zz(dense, widths, 8)


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    """Without nvcc the build raises; it never falls back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "NVCC_TOOLKIT_PATH", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not list(tmp_path.glob("*.so"))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails raises; no library is kept."""
    fails = shutil.which("false")  # exits 1 whatever its arguments
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda _: fails)
    with pytest.raises(RuntimeError, match=r"nvcc failed:\n\w+\.cu \(rc 1\)"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_import_loads_neither_jax_nor_the_jax_package():
    """The package and its modules that ``__init__`` does not import."""
    code = ("import sys, sprintz_tpu_torch\n"
            "import sprintz_tpu_torch.simple, sprintz_tpu_torch.transforms\n"
            "import sprintz_tpu_torch.univariate, sprintz_tpu_torch.univariate8b\n"
            "import sprintz_tpu_torch.models.online\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'sprintz_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


def test_port_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|sprintz_tpu)\b(?!_torch)",
                     re.M)
    files = sorted((REPO / "sprintz_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, f"{f.relative_to(REPO)} imports {hits}"
