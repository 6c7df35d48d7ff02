"""The readers of the program's counters (``portbench/counters.py``,
``metrics/pageable_MB.*``, ``metrics/host_threads.*``): on hand-made
snapshots here, and in a traced run of each cell on the card, where each
reads a value and no device operation carries a program span's name.
On the card: ``python3 -m pytest portbench/tests/test_portbench_counters.py
-q -m card``."""

import json
import subprocess
import sys
import types

import pytest

from portbench import counters, run

from .conftest import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = ["pageable_MB.decode", "pageable_MB.encode",
           "host_threads.decode", "host_threads.encode"]
SPAN_PREFIXES = ("sprintz.", "decode.", "encode.", "huf.")


def test_per_call_divides_by_the_calls_between():
    before = {"a": 5, "b": 1, "calls": 10}
    after = {"a": 25, "b": 11, "c": 7, "calls": 14}
    assert counters.per_call(before, after, ("a", "b"), "calls") == 7.5
    assert counters.per_call(before, after, ("c",), "calls") == 7 / 4
    assert counters.per_call(before, after, ("d",), "calls") is None
    assert counters.per_call(None, after, ("a",), "calls") is None
    assert counters.per_call(after, after, ("a",), "calls") is None


def test_snapshot_reads_the_program():
    got = counters.snapshot()
    assert got["native_host.threads_started"] >= 0
    assert "decoder.upload_payload.pageable_bytes" in got


@pytest.mark.parametrize("name", READERS)
def test_reader_on_snapshots(name, monkeypatch):
    mod = run.load_metric(name)
    start = {k: 100 for k in mod.KEYS} | {mod.CALLS: 4}
    now = {k: 100 + 3_000_000 for k in mod.KEYS} | {mod.CALLS: 7}
    mod.START = start
    monkeypatch.setattr(counters, "snapshot", lambda: now)
    card = types.SimpleNamespace(device=object())
    want = len(mod.KEYS) * 1_000_000
    got = mod.read(card)
    assert got == (want / 1e6 if name.startswith("pageable") else want)
    assert mod.read(types.SimpleNamespace(device=None)) is None
    mod.START = None  # a program without the counters
    assert mod.read(card) is None


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_traced_run_reads_counters(cell, card):
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", "3141592653", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    mine = [m["name"] for m in MANIFEST["per_layer"]
            if m["name"] in READERS and cell in m["workloads"]]
    assert len(mine) == 2
    for name in mine:
        assert result["metrics"][name]["value"] >= 0, name
    assert result["metrics"][mine[0]]["value"] > 0  # pageable bytes
    assert not [op for op, _ in result["breakdown"]["device_ops"]
                if op.startswith(SPAN_PREFIXES)]
