"""``probes/host_idle.py``: the device's idle time charged to the
program's spans on hand-made timelines (a gap half inside a span charges
only that half; nested spans charge the innermost), and the probe end to
end on the CPU at a tiny size."""

import contextlib
import io
import json

import pytest

from portbench.probes import host_idle

# a call: top span [0, 100) around a walk [10, 20) and a gather [30, 60)
# that holds a deeper span [40, 50); another top span [120, 130)
MARKS = [(0, 100, "sprintz.decompress"), (10, 20, "decode.walk"),
         (30, 60, "decode.gather"), (40, 50, "inner"),
         (120, 130, "sprintz.decompress")]


def test_segments_take_the_innermost_span():
    assert host_idle.innermost_segments(MARKS) == [
        (0, 10, "sprintz.decompress"), (10, 20, "decode.walk"),
        (20, 30, "sprintz.decompress"), (30, 40, "decode.gather"),
        (40, 50, "inner"), (50, 60, "decode.gather"),
        (60, 100, "sprintz.decompress"), (120, 130, "sprintz.decompress")]


def test_a_gap_half_inside_a_span_charges_that_half():
    segs = host_idle.innermost_segments(MARKS)
    gaps = [(15, 25)]  # half in the walk, half in the top span after it
    assert host_idle.charge_exact(gaps, segs) == pytest.approx(
        {"decode.walk": 5e-9, "sprintz.decompress": 5e-9, "outside": 0.0})
    assert host_idle.idle_under(gaps, [(10, 20), (30, 60)]) == 5
    # the midpoint charge gives the whole gap to the span at its middle
    assert host_idle.charge_midpoint(gaps, segs) == pytest.approx(
        {"sprintz.decompress": 10e-9})


def test_exact_charge_adds_up_to_the_idle_time():
    segs = host_idle.innermost_segments(MARKS)
    gaps = [(5, 15), (45, 70), (90, 125), (140, 150)]
    got = host_idle.charge_exact(gaps, segs)
    assert got == pytest.approx({
        "sprintz.decompress": 30e-9, "decode.walk": 5e-9, "inner": 5e-9,
        "decode.gather": 10e-9, "outside": 30e-9})
    assert sum(got.values()) == pytest.approx(
        sum(b - a for a, b in gaps) / 1e9)
    assert host_idle.idle_under(gaps, [(10, 20), (30, 60)]) == 5 + 15


@pytest.mark.parametrize("cell", ["ampd-u16-d3-xff.decode",
                                  "ucr-u8-d1-xff.encode"])
def test_probe_on_cpu(cell, tiny_configs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = host_idle.main(["--workload", cell, "--seed", "2147483659",
                             "--seconds", "0.3", "--device", "cpu"])
    assert rc == 0
    got = json.loads(out.getvalue().strip().splitlines()[-1])
    assert got["calls"] > 0 and got["top_spans"] == got["calls"]
    assert 0 < got["span_host_ms"] <= got["host_ms"]
    assert got["pageable_MB"] == 0  # no bus on the CPU
    assert got["reckoned_pageable_MB"] > 0
