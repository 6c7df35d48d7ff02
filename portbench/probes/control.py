"""The control's readings at a cell's own size: the harness's run with
``control.ControlCodec`` in the port's place, or with one of
``faults.FAULTS`` planted in the port (``--fault``), once a seed.

    python3 -m portbench.probes.control --workload <cell> \
        --seeds <n> [<n> ...] [--seconds 1] [--fault frozen_state]

On a machine with the card, as a cell's runs are; the control itself runs
on the host. Prints each run's compared numbers, one JSON line a seed,
and exits non-zero if any run came out correct."""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import sys

from .. import run
from ..control import ControlCodec
from ..faults import FAULTS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.probes.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    hooks = {} if args.fault else {"_codec": ControlCodec}
    undo = None
    if args.fault:
        side = "encode" if args.workload.endswith("encode") else "decode"
        module, name, broken = FAULTS[args.fault](side)
        owner = importlib.import_module(module)
        undo = (owner, name, getattr(owner, name))
        setattr(owner, name, broken)
    caught = 0
    try:
        for seed in args.seeds:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = run.main(["--workload", args.workload, "--seed",
                               str(seed), "--seconds", str(args.seconds),
                               "--trace", "0"], **hooks)
            lines = out.getvalue().strip().splitlines()
            result = json.loads(lines[-1]) if rc == 0 and lines else None
            caught += result is not None and not result["correct"]
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "fault": args.fault or "control", "rc": rc,
                              "correct": None if result is None
                              else result["correct"],
                              "checks": None if result is None
                              else result["checks"]}), flush=True)
    finally:
        if undo is not None:
            setattr(*undo)
    return 0 if caught == len(args.seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
