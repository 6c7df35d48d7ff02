"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program it judges: checked in a fresh
interpreter, so that no other test's imports count. Top-level module
names are compared whole: ``sprintz_tpu_torch`` is not ``sprintz_tpu``."""

import json
import subprocess
import sys

from .conftest import ROOT

PROBE = """
import json, sys
import {modules}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_after(*modules):
    proc = subprocess.run(
        [sys.executable, "-c", PROBE.format(modules=", ".join(modules))],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    found = top_level_after("portbench.run", "portbench.reference",
                            "portbench.control", "portbench.probes.control",
                            "portbench.entries.compress",
                            "portbench.entries.decompress",
                            "portbench.loops.closed", "portbench.faults",
                            "sprintz_tpu_torch")
    assert not found & {"jax", "jaxlib", "flax", "sprintz_tpu"}


def test_reference_stands_alone():
    found = top_level_after("portbench.reference")
    assert not found & {"jax", "jaxlib", "flax", "sprintz_tpu",
                        "sprintz_tpu_torch", "torch"}
