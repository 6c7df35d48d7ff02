"""Each cell for 2 seconds on the card, through the benchmark's own
command: the last line is the result, with every key the contract names.
Skipped without a card; on one: ``python3 -m pytest
portbench/tests/test_portbench_card.py -q -m card``."""

import json
import subprocess
import sys

import pytest

from .conftest import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(cell, trace, card):
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", "2718281828", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(result)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["count"] == 1
    assert result["device"]["memory_peak_bytes"] > 0
    assert list(result)[-1] == "checks"
    if trace:
        assert result["device"]["busy_s"] > 0
        assert {"device_ops", "idle_gaps"} <= set(result["breakdown"])
    else:
        assert set(result["metrics"]) == {
            m["name"] for m in MANIFEST["end_to_end"]
            if cell in m.get("workloads", [cell])}
