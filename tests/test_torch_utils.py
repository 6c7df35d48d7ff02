"""The port's utilities (``sprintz_tpu_torch/utils``) against the JAX
package's: debug dumps give the same strings and the host bit helpers the
same values (tolerance 0). The device timer and the profiler hook have no
JAX counterpart to equal: here, on the CPU, the timer perturbs its input as
the JAX loop perturbs its carry and puts it back, and the profiler writes a
Chrome trace holding the annotated range; both need the card unless told
otherwise."""

import glob
import json

import numpy as np
import pytest
import torch

from sprintz_tpu.utils import bits as jb
from sprintz_tpu.utils import debug as jd
from sprintz_tpu_torch.utils import bits as pb
from sprintz_tpu_torch.utils import debug as pd_
from sprintz_tpu_torch.utils import timing as ptime
from sprintz_tpu_torch.utils import trace as pt

BUFS = [b"", b"\x00", bytes(range(37)), b"\xff\x80\x01" * 11]


@pytest.mark.parametrize("x", [0, 1, 5, 255, 256, 0x12345678, 1 << 70,
                               b"\x01\x80", bytearray(b"\x0f\xf0"),
                               np.arange(5, dtype=np.uint8)])
def test_dump_bits_matches_jax(x):
    for lsb in (True, False):
        assert pd_.dump_bits(x, lsb) == jd.dump_bits(x, lsb)


@pytest.mark.parametrize("buf", BUFS)
def test_dump_bytes_and_diff_match_jax(buf):
    for per_line in (16, 5):
        assert pd_.dump_bytes(buf, per_line) == jd.dump_bytes(buf, per_line)
    for other in BUFS + [buf[:-1] + b"\x00" if buf else b"\x01"]:
        for ctx in (8, 2):
            assert (pd_.diff_streams(buf, other, ctx)
                    == jd.diff_streams(buf, other, ctx))


@pytest.mark.parametrize("ndims,max_rows", [(1, 32), (3, 4), (7, 100)])
def test_dump_elements_matches_jax(ndims, max_rows):
    arr = np.random.default_rng(ndims).integers(-500, 500, 101)
    assert (pd_.dump_elements(arr, ndims, max_rows)
            == jd.dump_elements(arr, ndims, max_rows))


@pytest.mark.parametrize("dtype", [np.int8, np.int16])
def test_zigzag_and_icopysign_match_jax(dtype):
    info = np.iinfo(dtype)
    x = np.arange(info.min, info.max + 1, dtype=dtype)
    u = pb.zigzag_encode(x)
    np.testing.assert_array_equal(u, jb.zigzag_encode(x))
    assert u.dtype == jb.zigzag_encode(x).dtype
    np.testing.assert_array_equal(pb.zigzag_decode(u), x)
    np.testing.assert_array_equal(pb.zigzag_decode(u), jb.zigzag_decode(u))
    rng = np.random.default_rng(7)
    s = rng.integers(info.min, info.max + 1, 5000).astype(dtype)
    v = rng.integers(info.min, info.max + 1, 5000).astype(dtype)
    s[::9] = 0
    got = pb.icopysign(s, v)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, jb.icopysign(s, v))
    for bad in (x.astype(np.int32), u.astype(np.uint32)):
        with pytest.raises(TypeError):
            (pb.zigzag_encode if bad.dtype == np.int32 else pb.zigzag_decode)(bad)


def test_row_bits_match_jax():
    rng = np.random.default_rng(8)
    for _ in range(200):
        d = int(rng.integers(1, 20))
        widths = rng.integers(0, 17, d)
        vals = rng.integers(0, 1 << 16, d).astype(np.uint16)
        acc = pb.pack_row_bits(vals, widths)
        assert acc == jb.pack_row_bits(vals, widths)
        np.testing.assert_array_equal(
            pb.unpack_row_bits(acc, widths, np.uint16),
            jb.unpack_row_bits(acc, widths, np.uint16))


def test_run_varints_match_jax():
    for n in range(0, 1 << 15, 7):
        enc = pb.encode_run_varint(n)
        assert enc == jb.encode_run_varint(n)
        buf = b"\x00" + enc + b"\x05"
        assert pb.decode_run_varint(buf, 1) == jb.decode_run_varint(buf, 1)
        assert pb.decode_run_varint(buf, 1) == (n, 1 + len(enc))


@pytest.mark.parametrize("iters", [1, 7, 16])
def test_device_loop_time_perturbs_and_restores(iters):
    """Each call sees the first element flipped as the JAX loop's carry
    (x, x^1, x^1, x, ...), after a warm-up call and a call that times the
    host's queueing; the tensor comes back."""
    arr = torch.arange(5, 15, dtype=torch.uint8).reshape(2, 5)
    other = torch.ones(3)
    seen = []

    def kernel(a, b):
        seen.append(int(a.view(-1)[0]))
        return a.sum() + b.sum()

    sec = ptime.device_loop_time(kernel, (arr, other), iters=iters)
    assert sec > 0
    want = [5, 5]
    v = 5
    for i in range(iters):
        v ^= i & 1
        want.append(v)
    assert seen == want
    assert torch.equal(arr, torch.arange(5, 15, dtype=torch.uint8).reshape(2, 5))
    seen.clear()
    ptime.device_loop_time(lambda b, a: kernel(a, b), [other, arr], iters=3,
                           vary=1)
    assert seen == [5, 5, 5, 4, 4]


def test_device_profile_writes_trace(tmp_path):
    with pt.device_profile(str(tmp_path), device="cpu") as prof:
        with pt.annotate("offcodec_range"):
            torch.arange(1000).cumsum(0)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name") == "offcodec_range" for e in events)
    assert any(e.key == "offcodec_range" for e in prof.key_averages())
    with pt.annotate("outside a profile"):
        pass


def test_device_profile_needs_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        with pt.device_profile(str(tmp_path)):
            pass
