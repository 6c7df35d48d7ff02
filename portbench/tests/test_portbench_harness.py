"""The harness on the CPU: cells found by name (a new configuration,
traffic mix and per-layer metric run without an edit of the harness), the
refusals (no card, no port beside it), and the comparison's control and
faults, each of which must come out not correct. The port runs on the
CPU through ``run.main``'s test-only ``_device="cpu"``."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import run
from portbench.control import ControlCodec
from portbench.faults import FAULTS as FAULTS_BY_NAME

from .conftest import ROOT

CELLS = ["ampd-u16-d3-xff.decode", "ucr-u8-d1-xff.decode",
         "ampd-u16-d3-xff.encode", "ucr-u8-d1-xff.encode"]


def run_cell(cell, seed=12345, trace=0, **hooks):
    """``run.main`` in this process -> (exit code, the last line's JSON).
    The run's look for JAX in ``sys.modules`` is off here: this process
    also holds the reference's tests, which import the JAX package's golden
    codec (``test_portbench_imports.py`` holds the look itself)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.MonkeyPatch.context() as mp:
        mp.setattr(run, "forbidden_modules", lambda: [])
        rc = run.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", "0.3", "--trace", str(trace)],
                      _device="cpu", **hooks)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def copy_benchmark(dest):
    """A checkout's benchmark files alone: BENCHMARK.json and portbench."""
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")


def subprocess_env(with_port: bool) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    if with_port:
        env["PYTHONPATH"] = str(ROOT)
    return env


ROUNDTRIP = '''
"""Each call compresses an input and decompresses the stream."""
from portbench import check
from portbench.loop import Prepared

KEYS = ()


def prepare(codec, inputs):
    return Prepared(lambda x: codec.decompress(codec.compress(x)),
                    list(inputs), [len(codec.compress(x)) for x in inputs])


def compare(config, inputs, prepared, window):
    return [("values_wrong",
             sum(check.values_wrong(out, inputs[window.inputs_used[i]])
                 for i, out in window.kept.items()), 0)]
'''

BURSTS = '''
"""Calls in bursts of ``burst`` back to back, a short pause after each."""
import time

from portbench.loop import Keeper, Window

KEYS = ("burst",)


def run(call, args, seconds, params, seed):
    keeper, lat, used = Keeper(params["keep"], seed), [], []
    i, start = 0, time.perf_counter()
    while True:
        for _ in range(params["burst"]):
            t = time.perf_counter()
            out = call(args[i % len(args)])
            lat.append(time.perf_counter() - t)
            used.append(i % len(args))
            keeper.offer(i, out)
            i += 1
        if time.perf_counter() - start >= seconds:
            return Window(start, time.perf_counter(), lat, used,
                          keeper.kept, 0, None)
        time.sleep(0.01)
'''


def test_new_cell_found_by_name(tmp_path):
    """A configuration, traffic mixes (one with an entry and a loop of its
    own) and a per-layer metric that the harness has never seen, added as
    files and manifest entries, run."""
    copy_benchmark(tmp_path)
    pb = tmp_path / "portbench"
    (pb / "configs" / "tiny-u8-d80-delta.json").write_text(json.dumps({
        "name": "tiny-u8-d80-delta", "source": "test", "profile":
        "msrc12_like", "rows": 1000, "ndims": 80, "elem_sz": 1,
        "codec": "delta", "entropy": "none", "assumed": {}, "reduced": []}))
    (pb / "traffic" / "encode3.json").write_text(json.dumps({
        "entry": "compress", "loop": "closed", "inputs": 3,
        "warmup_rounds": 1, "keep": 2,
        "rate_metric": "encode_GBps", "who": "test"}))
    # an entry that is neither compress nor decompress, and a loop with a
    # key of its own
    (pb / "entries" / "roundtrip.py").write_text(ROUNDTRIP)
    (pb / "loops" / "bursts.py").write_text(BURSTS)
    (pb / "traffic" / "roundtrip.json").write_text(json.dumps({
        "entry": "roundtrip", "loop": "bursts", "burst": 2, "inputs": 2,
        "warmup_rounds": 1, "keep": 3, "rate_metric": "roundtrip_GBps",
        "who": "test"}))
    (pb / "metrics" / "plan_ms.encode.py").write_text(
        'LAYER = "host runtime"\nSOURCE = "program_span"\n'
        'MOVES = "encode_GBps"\n'
        'WRAPS = ("sprintz_tpu_torch.encoder.build_plan",)\n\n\n'
        'def read(r):\n    return r.span_ms(WRAPS)\n')
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cell = "tiny-u8-d80-delta.encode3"
    manifest["workloads"].append({"name": cell, "config":
                                  "tiny-u8-d80-delta", "traffic": "encode3",
                                  "chips": 1, "why": "test"})
    manifest["per_layer"].append({
        "name": "plan_ms.encode", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "host runtime",
        "moves": "encode_GBps", "workloads": [cell]})
    rt = "tiny-u8-d80-delta.roundtrip"
    manifest["workloads"].append({"name": rt, "config": "tiny-u8-d80-delta",
                                  "traffic": "roundtrip", "chips": 1,
                                  "why": "test"})
    manifest["end_to_end"].append({
        "name": "roundtrip_GBps", "unit": "GB/s", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": [rt]})
    for m in manifest["end_to_end"]:
        if m["name"] == "encode_GBps":
            m["workloads"].append(cell)
        if m["name"] == "p95_ms":
            m["workloads"] += [cell, rt]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    code = ("import sys; from portbench import run; sys.exit(run.main("
            "sys.argv[1:], _device='cpu'))")
    for name, trace, want in (
            (cell, 0, {"encode_GBps", "p95_ms", "setup_s"}),
            (cell, 1, {"plan_ms.encode"}),
            (rt, 0, {"roundtrip_GBps", "p95_ms", "setup_s"})):
        proc = subprocess.run(
            [sys.executable, "-c", code, "--workload", name, "--seed", "7",
             "--seconds", "0.3", "--trace", str(trace)],
            cwd=tmp_path, env=subprocess_env(True), capture_output=True,
            text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        assert result["correct"], proc.stderr[-3000:]
        assert set(result["metrics"]) == want
        assert list(result)[-1] == "checks"


def test_no_card_no_result():
    """The real command, without a card, exits non-zero and prints no
    result."""
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=subprocess_env(True), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_no_port_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and portbench, the port is
    not there: the run exits non-zero and prints no result."""
    copy_benchmark(tmp_path)
    code = ("import sys; from portbench import run; sys.exit(run.main("
            "sys.argv[1:], _device='cpu'))")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=subprocess_env(False), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run(cell, tiny_configs):
    rc, result = run_cell(cell)
    assert rc == 0 and result["correct"]
    assert all(c["value"] == 0 for c in result["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, tiny_configs):
    """The reference at the lower precision in the port's place."""
    rc, result = run_cell(cell, _codec=ControlCodec)
    assert rc == 0 and not result["correct"]
    key = ("setup_stream_bytes_wrong" if cell.endswith("decode")
           else "stream_bytes_wrong")
    assert result["checks"][key]["value"] > 0


# Every cell can show every fault: on the AMPds profile's ramps FIRE's
# coefficient moves, so a frozen state writes other streams there too.
FAULTS = [(cell, fault) for cell in CELLS
          for fault in sorted(FAULTS_BY_NAME)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-_{f}" for c, f in FAULTS])
def test_fault_fails(cell, fault, tiny_configs, monkeypatch):
    """The timed path broken underneath; the harness drives the rest."""
    module, name, broken = FAULTS_BY_NAME[fault](cell.rsplit(".", 1)[1])
    monkeypatch.setattr(sys.modules[module], name, broken)
    rc, result = run_cell(cell)
    assert rc == 0 and not result["correct"]


def test_traced_run_on_cpu(tiny_configs):
    """A traced run on the CPU: the span metrics read, the device's are
    left out (no device trace), and the comparison is the same."""
    rc, result = run_cell(CELLS[0], trace=1)
    assert rc == 0 and result["correct"]
    assert set(result["metrics"]) == {"api_self_ms.decode",
                                      "host_ms.decode"}
    assert np.isfinite(result["metrics"]["host_ms.decode"]["value"])


def test_traced_encode_reads_call_tail(tiny_configs):
    """The AMPds encode cell reports its call's tail per layer, from the
    entry's spans, and not ``p95_ms`` end to end."""
    rc, result = run_cell(CELLS[2], trace=1)
    assert rc == 0 and result["correct"]
    assert set(result["metrics"]) == {"api_self_ms.encode",
                                      "call_p95_ms.encode", "host_ms.encode"}
    assert result["metrics"]["call_p95_ms.encode"]["value"] > 0
    rc, result = run_cell(CELLS[2], trace=0)
    assert rc == 0 and set(result["metrics"]) == {"encode_GBps", "setup_s"}


def test_metric_files_match_manifest():
    """Each per-layer metric of BENCHMARK.json has its reader, which
    declares the same layer, source and moved metric."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in manifest["per_layer"]:
        mod = run.load_metric(m["name"])
        assert (mod.LAYER, mod.SOURCE, mod.MOVES) == (
            m["layer"], m["source"], m["moves"])
        assert callable(mod.read)
