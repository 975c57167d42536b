#!/usr/bin/env python3
"""The control of the benchmark's check: the plain reference with one of
the configuration's guarantees broken, put in the program's place under
a run of the cell, must come out as not correct.

    python3 perfbench/control.py --workload <cell> --seeds 101 102 103

For each seed it makes a run of the cell as the benchmark does (set-up
on the card, the window, the check), except that in the window every
grid's results are the reference's with EASY backfilling's reservation
broken (a backfilled job may delay the head job), for every sim of the
grid, and prints the run's ``correct`` and compared numbers as one JSON
line.  It needs a card, as a run does; the benchmark's own runs do not
run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BROKEN = "reservation"


class ControlResult:
    """A grid's results as the check reads them, from reference runs."""

    def __init__(self, refs):
        self.refs = refs

    def summary(self, i):
        return self.refs[i]

    def trace(self, i):
        return self.refs[i]["trace"]


class ControlRunner:
    """Stands in for ``FleetRunner``: every grid returns ``result``."""

    def __init__(self, result):
        self.result = result

    def run(self, sims):
        return self.result


def put_in_place(ent):
    """The entry hook: the broken reference of every sim of the grid in
    the program's place."""
    ent_mod = sys.modules[type(ent).__module__]
    refs = ent_mod.run_references(ent.reference_jobs(), BROKEN)
    ent.runner = ControlRunner(ControlResult(refs))


def control_run(cell, seed: int, seconds: float, device: str,
                entry_args=None):
    """The result line of a run of ``cell`` with the control in the
    program's place."""
    from perfbench import run

    res, _ = run.run(cell, seed, seconds, False, device,
                     time.perf_counter(), entry_args=entry_args,
                     entry_hook=put_in_place)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("perfbench control: needs a CUDA device", file=sys.stderr)
        return 3
    cell = harness.resolve(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = control_run(cell, seed, args.seconds, "cuda")
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "broken": BROKEN, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "compared": res["compared"],
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
