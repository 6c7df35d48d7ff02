"""The one traffic generator: a mix is a file of parameters,
``traffic/<name>.json``, that this module reads. It names an entry
(``entries/<entry>.py``: what set-up makes, what each call calls, and what
the comparison checks) and a loop (``loops/<loop>.py``: how the client
calls), both found by name, so that a later mix adds files and edits
none. Call i takes input i mod the number of inputs; a call's work is its
input array's bytes.

Keys of every mix:
  entry         the entry module's name
  loop          the loop module's name
  inputs        how many arrays set-up makes from the seed, all of the
                configuration's size
  warmup_rounds rounds over every input before the window, in set-up
  keep          how many calls' answers the comparison checks: a sample
                of that many calls, drawn from the seed
  rate_metric   the name under which the rate is reported
  who           who sends such traffic
An entry or a loop may read keys of its own, which it lists in its
``KEYS``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import random
from typing import Any, Callable

import numpy as np

from . import gen

HERE = pathlib.Path(__file__).resolve().parent
TRAFFIC_DIR = HERE / "traffic"
CONFIG_DIR = HERE / "configs"
KEYS = {"entry", "loop", "inputs", "warmup_rounds", "keep", "rate_metric",
        "who"}


def load_part(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark (an entry, a loop or a
    per-layer metric's reader) as a module."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {kind} module {name!r} ({path.name})")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Mix:
    params: dict  # the traffic file
    entry: Any  # its entry module
    loop: Any  # its loop module


def load_traffic(name: str) -> Mix:
    params = json.loads((TRAFFIC_DIR / f"{name}.json").read_text())
    if KEYS - set(params):
        raise ValueError(f"traffic {name}: missing {KEYS - set(params)}")
    entry = load_part("entries", params["entry"])
    loop = load_part("loops", params["loop"])
    unknown = set(params) - KEYS - set(entry.KEYS) - set(loop.KEYS)
    if unknown:
        raise ValueError(f"traffic {name}: unknown keys {unknown}")
    return Mix(params, entry, loop)


def load_config(name: str) -> dict:
    return json.loads((CONFIG_DIR / f"{name}.json").read_text())


def seed_words(seed: int, k: int) -> list[int]:
    """The generator's seed for input k: the seed's magnitude, its sign,
    and k, so that every whole number is a seed of its own."""
    return [abs(seed), int(seed < 0), k]


def make_inputs(config: dict, params: dict, seed: int) -> list[np.ndarray]:
    """The mix's inputs: arrays of the configuration's rows. Where the
    configuration gives ``series_rows``, an array is that many rows' series
    end to end, each made and quantized on its own (series j of input k from
    the seed words [seed, k, j]), as an archive of short series is stored;
    else it is one series."""
    dtype = np.uint8 if config["elem_sz"] == 1 else np.uint16
    rows = config["rows"]
    per = config.get("series_rows", rows)
    if rows % per:
        raise ValueError("rows must be a whole number of series")
    out = []
    for k in range(params["inputs"]):
        words = seed_words(seed, k)
        x = (gen.synthetic(config["profile"], rows, dtype, words)
             if per == rows else np.concatenate(
                 [gen.synthetic(config["profile"], per, dtype, words + [j])
                  for j in range(rows // per)]))
        if x.shape[1] != config["ndims"]:
            raise ValueError("profile and configuration disagree on ndims")
        out.append(x)
    return out


@dataclasses.dataclass
class Prepared:
    """What an entry's set-up made: the loop calls ``call(args[i % n])``."""

    call: Callable
    args: list
    compressed: list[int]  # each input's stream bytes, for the roofline
    state: Any = None  # what the comparison needs besides the inputs


@dataclasses.dataclass
class Window:
    start: float  # host clock, s
    end: float
    latencies: list[float]  # s, every call in order
    inputs_used: list[int]  # the input each call took
    kept: dict[int, object]  # call index -> its answer
    failed: int
    first_error: str | None

    @property
    def calls(self) -> int:
        return len(self.latencies)


class Keeper:
    """A sample of ``keep`` calls' answers, drawn from the seed as the
    calls come (reservoir sampling)."""

    def __init__(self, keep: int, seed: int):
        self.keep = keep
        self.rng = random.Random(seed)
        self.kept: dict[int, object] = {}
        self.slots: list[int] = []

    def offer(self, i: int, out) -> None:
        if i < self.keep:
            self.kept[i] = out
            self.slots.append(i)
            return
        j = self.rng.randrange(i + 1)
        if j < self.keep:
            del self.kept[self.slots[j]]
            self.slots[j] = i
            self.kept[i] = out
