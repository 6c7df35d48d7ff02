"""The reader of the decode's fresh output memory
(``metrics/fresh_out_MB.decode``): on hand-made snapshots, and on the
program's own counter after decodes on the CPU, where a result still held
makes the next call take a fresh block and a dropped one is recycled."""

import json
import types

import numpy as np
import pytest

from portbench import counters, gen, run

from .conftest import ROOT

NAME = "fresh_out_MB.decode"
CARD = types.SimpleNamespace(device=object())


def test_manifest_lists_the_decode_cells():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in manifest["per_layer"] if m["name"] == NAME)
    decodes = [w["name"] for w in manifest["workloads"]
               if w["traffic"] == "decode"]
    assert entry["workloads"] == decodes
    assert (entry["layer"], entry["moves"], entry["better"]) == (
        "API", "decode_GBps", "lower")


def test_reader_on_snapshots(monkeypatch):
    mod = run.load_metric(NAME)
    mod.START = {mod.KEYS[0]: 1000, mod.CALLS: 4}
    now = {mod.KEYS[0]: 1000 + 115_097_600, mod.CALLS: 104}
    monkeypatch.setattr(counters, "snapshot", lambda: now)
    assert mod.read(CARD) == pytest.approx(1.150976)
    assert mod.read(types.SimpleNamespace(device=None)) is None
    mod.START = None  # a program without the counters
    assert mod.read(CARD) is None
    # a program without the pool: no such counter
    mod.START = {mod.CALLS: 4}
    monkeypatch.setattr(counters, "snapshot", lambda: {mod.CALLS: 7})
    assert mod.read(CARD) is None


def test_reader_on_the_program(monkeypatch):
    from sprintz_tpu_torch import SprintzCodec, decoder

    # a pool of this test's own, without other tests' free blocks
    monkeypatch.setattr(decoder, "_OUT",
                        decoder._OutPool(decoder.OUT_FREE_BLOCKS))
    mod = run.load_metric(NAME)
    x = gen.synthetic("msrc12_like", 1000, np.uint8, [7, 0, 0])
    codec = SprintzCodec("delta", 1, device="cpu")
    buf = codec.compress(x)
    held = codec.decompress(buf)  # leaves no free block of its size
    mod.START = counters.snapshot()
    kept = codec.decompress(buf)  # fresh: held is alive
    del held
    for _ in range(2):  # recycled: held's block, then the first of these
        assert np.array_equal(codec.decompress(buf), x.reshape(-1))
    assert np.array_equal(kept, x.reshape(-1))
    assert mod.read(CARD) == pytest.approx(x.nbytes / 3 / 1e6)
