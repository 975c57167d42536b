#!/usr/bin/env python3
"""Time the ``fleet_engine`` kernel's launches on one GPU, for one tree.

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``::

    python3 benchmarks_torch/fleet_launches.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` runs (this
checkout's by default), so that an earlier commit unpacked with ``git
archive`` can be timed in the same call as this one; each tree builds
its kernels into its own ``build/``.  The grids are chip_smoke.py's
phases 8 and 9: the Seth grid (the 8 Table-2 policies x 16 seeds of the
Seth stream, 128 sims of 10,000 jobs on 120 nodes; the smoke runs it at
4,000 jobs a sim) and the RICC-sized system (the 8 policies, 5,000 jobs
on 1024 nodes), every sim to its end.  A warm-up run of the Seth grid's seed 0 (its 8 sims) first makes
the CUDA context and loads the kernel, as chip_smoke.py's earlier phases
have when it times the grid.  Each grid then runs once through
``FleetRunner().run`` (its wall gives the grid's events/s, stacking and
copies included), then each of its
two launches (blocking, EBF) runs again alone, timed with CUDA events by
``chip_smoke.time_launches``, which also holds its finals equal to the
run's.  Prints the card's name and power limit, then one JSON line per
grid run and per launch.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# jobs a sim of the Seth grid, as this script has always timed it
SETH_GRID_JOBS = 10_000


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory whose repro_torch runs")
    ap.add_argument("--label", default="this tree",
                    help="a name for the tree, copied into every line")
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    # bind the package to --src before chip_smoke puts this checkout's
    # src first on the path
    import repro_torch
    if not os.path.abspath(repro_torch.__file__).startswith(src + os.sep):
        raise SystemExit(f"repro_torch comes from {repro_torch.__file__}, "
                         f"not {src}")
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from repro_torch.core import Job
    from repro_torch.fleet import SCHED_FIFO, FleetRunner
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("fleet_launches: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log({"label": args.label, "src": src, "card": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda})
    build.library("fleet_engine")
    seth = [sim for seed in range(cs.FLEET_SEEDS)
            for sim in cs.policy_sims(FleetRunner.build(
                "seth", cs.seth_jobs(SETH_GRID_JOBS, seed), cs.SETH,
                SCHED_FIFO, seed=seed), seed, f"-s{seed}")]
    ricc = cs.policy_sims(FleetRunner.build(
        "ricc", cs.ricc_jobs(Job, cs.RICC_JOBS), cs.RICC, SCHED_FIFO))
    t0 = time.perf_counter()
    FleetRunner().run(seth[:len(cs.POLICIES)])
    torch.cuda.synchronize()
    cs.log({"label": args.label, "warm_up_s": time.perf_counter() - t0})
    for grid, sims in (("seth", seth), ("ricc", ricc)):
        t0 = time.perf_counter()
        res = FleetRunner().run(sims)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        events = sum(int(f.n_events) for f in res.finals)
        cs.log({"label": args.label, "grid": grid, "sims": len(sims),
                "events": events, "wall_s": wall,
                "events_per_s": events / wall})
        cs.time_launches(res, sims, grid, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
