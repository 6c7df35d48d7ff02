"""The frozen reference codec against the JAX package's golden codec and
against the reference implementation's streams in ``tests/vectors``, at
small sizes on the CPU; and its lower precision, the control's, against
the format's."""

import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from portbench import reference  # noqa: E402
from portbench.control import ControlCodec  # noqa: E402
from sprintz_tpu.golden.lowdim import compress_lowdim_rle  # noqa: E402
from sprintz_tpu.golden.rowmajor import compress_rowmajor_rle  # noqa: E402

from .conftest import ROOT  # noqa: E402

VECTORS = ROOT / "tests" / "vectors"
MANIFEST = json.loads((VECTORS / "manifest.json").read_text())


def make(rng, n, ndims, elem_sz, kind):
    dt = np.uint8 if elem_sz == 1 else np.uint16
    top = 1 << (8 * elem_sz)
    if kind == "walk":
        x = np.cumsum(rng.integers(-20, 21, (n, ndims)), axis=0)
    elif kind == "runs":  # constant stretches (RLE runs), a noisy patch
        x = np.repeat(rng.integers(0, top, (n // 90 + 1, ndims)), 90,
                      axis=0)[:n]
        x[300:340] = rng.integers(0, top, (40, ndims))
    elif kind == "long_runs":  # runs past a 1-byte varint and the cap
        x = np.zeros((n, ndims), np.int64)
        x[n // 2:n // 2 + 8] = rng.integers(0, top, (8, ndims))
    else:  # full-range noise: the widest fields
        x = rng.integers(0, top, (n, ndims))
    return (x % top).astype(dt)


@pytest.mark.parametrize("case", MANIFEST, ids=[m["name"] for m in MANIFEST])
def test_vectors(case):
    dt = np.uint8 if case["elem_sz"] == 1 else np.uint16
    x = np.fromfile(VECTORS / f"{case['name']}.in", dtype=dt)
    stream = (VECTORS / f"{case['name']}.sprintz").read_bytes()
    assert reference.encode(x, case["codec"], case["ndims"]) == stream
    assert np.array_equal(
        reference.decode(stream, case["codec"], case["elem_sz"]), x)


@pytest.mark.parametrize("kind", ["walk", "runs", "long_runs", "noise"])
@pytest.mark.parametrize("codec", ["delta", "xff"])
@pytest.mark.parametrize("elem_sz,ndims", [(1, 1), (1, 3), (1, 4), (1, 5),
                                           (1, 17), (2, 1), (2, 2), (2, 3),
                                           (2, 9)])
def test_golden(elem_sz, ndims, codec, kind):
    rng = np.random.default_rng(1000 * elem_sz + 10 * ndims + len(kind))
    n = 2000 + int(rng.integers(0, 40))
    if kind == "long_runs":
        n = 8 * 300 + 8 * 0x80 * 2 + 5
    x = make(rng, n, ndims, elem_sz, kind)
    lowdim = reference.is_lowdim(ndims, elem_sz)
    golden = (compress_lowdim_rle if lowdim else compress_rowmajor_rle)(
        x.reshape(-1), ndims, codec)
    stream = reference.encode(x, codec)
    assert stream == golden
    assert np.array_equal(reference.decode(stream, codec, elem_sz),
                          x.reshape(-1))


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 200])
def test_short_streams(n):
    x = np.arange(n, dtype=np.uint8)
    stream = reference.encode(x, "xff", 1)
    assert stream == compress_lowdim_rle(x, 1, "xff")
    assert np.array_equal(reference.decode(stream, "xff", 1), x)


@pytest.mark.parametrize("elem_sz,ndims,control", [
    (1, 1, {"kind": "fire_coefficient", "trunc_bits": 4}),
    (2, 3, {"kind": "fire_coefficient", "trunc_bits": 3}),
    (2, 2, {"kind": "fire_coefficient", "trunc_bits": 4})])
def test_control_precision(elem_sz, ndims, control):
    """The control's streams differ from the format's, and it gives other
    values for the format's streams; it is lossless on its own streams."""
    rng = np.random.default_rng(7)
    x = make(rng, 4000, ndims, elem_sz, "walk")
    ctl = ControlCodec({"codec": "xff", "elem_sz": elem_sz, "ndims": ndims,
                        "control": control})
    stream = reference.encode(x, "xff")
    low = ctl.compress(x)
    assert low != stream
    assert not np.array_equal(ctl.decompress(stream), x.reshape(-1))
    assert np.array_equal(ctl.decompress(low), x.reshape(-1))
