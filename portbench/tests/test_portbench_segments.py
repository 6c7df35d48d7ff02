"""The reader of the decode's segments (``metrics/segments.decode``): on
hand-made snapshots, on the program's own counter after a decode on the
CPU, and in a traced run of each decode cell on the card, where it reads
a count of segments and the decode's copies are pinned. On the card:
``python3 -m pytest portbench/tests/test_portbench_segments.py -q -m
card``."""

import json
import subprocess
import sys
import types

import numpy as np
import pytest

from portbench import counters, run

from .conftest import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = "segments.decode"
CELLS = next(m for m in MANIFEST["per_layer"] if m["name"] == NAME)[
    "workloads"]


def test_reader_on_snapshots(monkeypatch):
    mod = run.load_metric(NAME)
    now = {mod.KEYS[0]: 100 + 24, mod.CALLS: 7}
    mod.START = {mod.KEYS[0]: 100, mod.CALLS: 4}
    monkeypatch.setattr(counters, "snapshot", lambda: now)
    card = types.SimpleNamespace(device=object())
    assert mod.read(card) == 8
    assert mod.read(types.SimpleNamespace(device=None)) is None
    mod.START = None  # a program without the counter
    assert mod.read(card) is None
    mod.START = {mod.CALLS: 4}
    monkeypatch.setattr(counters, "snapshot", lambda: {mod.CALLS: 7})
    assert mod.read(card) is None


def test_reader_counts_a_call_on_the_program():
    from sprintz_tpu_torch import SprintzCodec

    mod = run.load_metric(NAME)
    x = np.cumsum(np.random.default_rng(5).integers(-3, 4, 600),
                  dtype=np.int64).astype(np.uint8)
    codec = SprintzCodec("xff", 1, device="cpu")
    buf = codec.compress(x, 1)
    mod.START = counters.snapshot()
    for _ in range(2):
        assert np.array_equal(codec.decompress(buf), x)
    assert mod.read(types.SimpleNamespace(device=object())) == 1


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_traced_decode_reads_segments(cell, card):
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", "3141592653", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    got = {k: result["metrics"][k]["value"]
           for k in (NAME, "pageable_MB.decode")}
    assert got[NAME] >= 1, got
    assert got[NAME] == int(got[NAME]), got  # each call, the same plan
    assert got["pageable_MB.decode"] < 0.1, got
