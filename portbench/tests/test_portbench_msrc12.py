"""The MSRC-12 cell (``msrc12-u8-d80-delta.decode``, the port's main path)
on the CPU at a tiny size: a sound run is correct, and the faults that
reach the delta decode (``half_left_out``, ``answer_altered``) make it not
correct; a traced run reads its span metrics. Its three readers
(``host_copy_MB.decode``, ``join_ms.decode``, ``delta_pass_roofline.decode``)
on hand-made snapshots, spans and device traces, and on the program's own
counters after a decode."""

import sys
import types

import numpy as np
import pytest

from portbench import counters, run
from portbench.devtrace import DeviceOp, DeviceTrace
from portbench.faults import FAULTS
from portbench.reading import Reading
from portbench.spans import Span

from .test_portbench_harness import run_cell

CELL = "msrc12-u8-d80-delta.decode"
D = "sprintz_tpu_torch.decoder."


def test_sound_run(tiny_configs):
    rc, result = run_cell(CELL)
    assert rc == 0 and result["correct"]
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert set(result["metrics"]) == {"decode_GBps", "setup_s"}


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered"])
def test_fault_fails(fault, tiny_configs, monkeypatch):
    module, name, broken = FAULTS[fault]("decode")
    monkeypatch.setattr(sys.modules[module], name, broken)
    rc, result = run_cell(CELL)
    assert rc == 0 and not result["correct"]
    assert result["checks"]["values_wrong"]["value"] > 0


def test_traced_run_on_cpu(tiny_configs):
    """No device trace on the CPU: the span metrics read, the device's and
    the counters' are left out."""
    rc, result = run_cell(CELL, trace=1)
    assert rc == 0 and result["correct"]
    assert set(result["metrics"]) == {"api_self_ms.decode", "host_ms.decode",
                                      "join_ms.decode"}
    assert result["metrics"]["join_ms.decode"]["value"] > 0


def test_host_copy_on_snapshots(monkeypatch):
    mod = run.load_metric("host_copy_MB.decode")
    mod.START = {mod.KEYS[0]: 100, mod.KEYS[1]: 50, mod.CALLS: 4}
    now = {mod.KEYS[0]: 100 + 162_000_000, mod.KEYS[1]: 50 + 172_500_000,
           mod.CALLS: 7}
    monkeypatch.setattr(counters, "snapshot", lambda: now)
    card = types.SimpleNamespace(device=object())
    assert mod.read(card) == pytest.approx(111.5)
    assert mod.read(types.SimpleNamespace(device=None)) is None
    mod.START = None  # a program without the counters
    assert mod.read(card) is None
    # a program whose join counts nothing (one older than the counter)
    mod.START = {mod.KEYS[0]: 100, mod.CALLS: 4}
    monkeypatch.setattr(counters, "snapshot", lambda: {
        mod.KEYS[0]: 200, mod.CALLS: 7})
    assert mod.read(card) is None


def test_host_copy_on_the_program():
    from sprintz_tpu_torch import SprintzCodec
    from portbench import gen

    mod = run.load_metric("host_copy_MB.decode")
    x = gen.synthetic("msrc12_like", 1000, np.uint8, [5, 0, 0])
    codec = SprintzCodec("delta", 1, device="cpu")
    buf = codec.compress(x)
    before = mod.START = counters.snapshot()
    for _ in range(2):
        assert np.array_equal(codec.decompress(buf), x.reshape(-1))
    after = counters.snapshot()
    dense = (after[mod.KEYS[0]] - before[mod.KEYS[0]]) / 2
    assert dense > 0
    got = mod.read(types.SimpleNamespace(device=object()))
    assert got == pytest.approx((dense + x.nbytes) / 1e6)


def reading(spans=(), ops=(), calls=2, missing=(), peaks=True):
    dev = DeviceTrace(list(ops), 0, 10**9) if ops is not None else None
    return Reading(spans=list(spans), calls=calls, device=dev,
                   uncompressed_bytes=57_548_800, compressed_bytes=11_832_168,
                   peaks={"hbm_bytes_per_s": 3.35e12} if peaks else None,
                   missing=set(missing))


def test_join_ms_on_spans():
    mod = run.load_metric("join_ms.decode")
    ms = 1_000_000
    spans = [Span(D + "decompress", 0, 40 * ms, -1),
             Span(D + "_join", 10 * ms, 20 * ms, 0),
             Span(D + "download_values", 11 * ms, 14 * ms, 1),
             Span(D + "_join", 30 * ms, 32 * ms, 0)]
    assert mod.read(reading(spans)) == pytest.approx((10 - 3 + 2) / 2)
    assert mod.read(reading(spans, missing={D + "_join"})) is None
    assert mod.read(reading(spans, missing={D + "download_values"})) is None


def test_delta_pass_roofline_on_device_ops():
    mod = run.load_metric("delta_pass_roofline.decode")
    us = 1000
    ops = [DeviceOp("void (anonymous namespace)::unpack_zz_kernel<8, false, "
                    "true, false>(unsigned char const*, ...)", "kernel",
                    0, 100 * us),
           DeviceOp("void (anonymous namespace)::prefix_finish_kernel<8, "
                    "true, false, false>(unsigned char const*, ...)",
                    "kernel", 100 * us, 160 * us),
           DeviceOp("void at::native::index_elementwise_kernel<...>",
                    "kernel", 160 * us, 400 * us),
           DeviceOp("Memcpy HtoD (Pinned -> Device)", "memcpy",
                    400 * us, 900 * us)]
    least = (57_548_800 + 11_832_168) / 3.35e12 * 1e3
    got = mod.read(reading(ops=ops))
    assert got == pytest.approx(100 * least / (160 / 1000 / 2))
    assert 0 < got < 100
    assert mod.read(reading(ops=ops[2:])) is None  # no K1 or K2
    assert mod.read(reading(ops=None)) is None  # no device trace
    assert mod.read(reading(ops=ops, peaks=False)) is None
