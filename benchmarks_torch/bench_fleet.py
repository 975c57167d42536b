"""Fleet engine throughput — whole dispatcher×seed grids in one launch.

The claim under test (DESIGN.md §8): once the event loop runs on the
device for every sim of a grid at once, simulating a GRID costs barely
more than simulating one member, so aggregate events/s scales with grid
width while the serial host engine pays full price per grid point.  Both
engines run the identical grid (every dispatcher × every seed, same
workloads, same system) and the bench cross-checks their per-sim
outcomes before reporting:

* ``host``  — one ``Simulator`` run per grid point, back to back;
* ``fleet`` — ONE ``FleetRunner.run`` over the stacked grid, the
  ``fleet_engine`` kernel with one thread block per sim
  (``compile_time_s`` is the kernel library's build or load, paid once
  per process; ``compile_cache_hit`` says whether every launch's padded
  shape was seen before in this process).

The grid is the paper's full Table-2 policy set: {FIFO, SJF, LJF, EBF} ×
{FirstFit, BestFit} — all eight rows lower onto the fleet engine
(``fleet_covered_fraction`` reports the lowered share and the bench
refuses silent host fallback).  Per-row events/s compare each
dispatcher's host and amortized-fleet throughput individually, on top of
the aggregate.

The fleet runs on ``device``: None means the card (and raises without
one), ``"cpu"`` runs the plain PyTorch version.  Writes
``BENCH_torch_fleet.json`` at the repo root (full grid: 8 dispatchers ×
5 seeds = 40 sims; ``--quick``: FIFO-FF + EBF-BF × 2 seeds on a shorter
workload — the CI smoke).

    PYTHONPATH=src python -m benchmarks_torch.run --fleet           # full grid
    PYTHONPATH=src python -m benchmarks_torch.run --fleet --quick   # CI smoke
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List

from repro_torch.core.dispatchers import (BestFit, EasyBackfilling, FirstFit,
                                          FirstInFirstOut, LongestJobFirst,
                                          ShortestJobFirst)
from repro_torch.core.job import JobFactory
from repro_torch.core.simulator import Simulator
from repro_torch.fleet import FleetRunner, dispatch_code
from repro_torch.workloads.synthetic import SyntheticWorkload

from .common import bench_metadata, emit

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SYSTEM = {"groups": {"a": {"core": 4, "mem": 1024},
                     "b": {"core": 8, "mem": 2048}},
          "nodes": {"a": 6, "b": 4}}

# the paper's Table-2 policy grid: scheduler x allocator, all on the fleet
GRID = [(f"{s_name}-{a_name}", s_cls, a_cls)
        for s_name, s_cls in (("FIFO", FirstInFirstOut),
                              ("SJF", ShortestJobFirst),
                              ("LJF", LongestJobFirst),
                              ("EBF", EasyBackfilling))
        for a_name, a_cls in (("FF", FirstFit), ("BF", BestFit))]
GRID_QUICK = [GRID[0], GRID[7]]          # FIFO-FF + EBF-BF (CI smoke)

BASE_SEED = 29
N_SEEDS_FULL = 5           # 8 x 5 = 40 sims (the >=32-sim grid)
N_SEEDS_QUICK = 2
JOBS_FULL = 400
JOBS_QUICK = 120


def _workload(n_jobs: int, seed: int) -> SyntheticWorkload:
    return SyntheticWorkload(
        n_jobs, seed=seed, mean_interarrival_s=25.0,
        duration_median_s=900.0, duration_sigma=1.1,
        node_weights={1: 0.5, 2: 0.3, 4: 0.2},
        resources={"core": (1, 4), "mem": (64, 1024)})


def run(out_dir: str, quick: bool = False, device=None) -> Dict:
    os.makedirs(out_dir, exist_ok=True)
    runner = FleetRunner(device=device)
    n_seeds = N_SEEDS_QUICK if quick else N_SEEDS_FULL
    n_jobs = JOBS_QUICK if quick else JOBS_FULL
    rows = GRID_QUICK if quick else GRID
    codes = {tag: dispatch_code(s_cls(a_cls()))
             for tag, s_cls, a_cls in rows}
    # the whole Table-2 grid must lower onto the fleet engine — a silent
    # host fallback would corrupt the fleet numbers
    fallbacks = [tag for tag, pair in codes.items() if pair is None]
    assert not fallbacks, f"host fallback rows: {fallbacks}"
    grid = [(f"{tag}-s{BASE_SEED + i}", tag, s_cls, a_cls, BASE_SEED + i)
            for tag, s_cls, a_cls in rows for i in range(n_seeds)]

    # --- serial host baseline: one Simulator per grid point -----------
    host_outcomes: List[Dict] = []
    host_row_wall: Dict[str, float] = {tag: 0.0 for tag, _, _ in rows}
    t0 = time.time()
    for name, tag, s_cls, a_cls, seed in grid:
        t_row = time.time()
        sim = Simulator(_workload(n_jobs, seed), SYSTEM, s_cls(a_cls()),
                        job_factory=JobFactory(), output_dir=out_dir,
                        name=f"fleetbench-{name}")
        sim.start_simulation(write_output=False)
        host_row_wall[tag] += time.time() - t_row
        s = sim.summary
        host_outcomes.append({"name": name, "events": s["events"],
                              "completed": s["completed"],
                              "rejected": s["rejected"],
                              "sim_end_time": s["sim_end_time"]})
    host_wall = max(time.time() - t0, 1e-9)
    host_events = sum(o["events"] for o in host_outcomes)

    # --- one batched fleet launch over the whole grid -----------------
    sims = [FleetRunner.build(name, _workload(n_jobs, seed), SYSTEM,
                              codes[tag][0], alloc_id=codes[tag][1],
                              job_factory=JobFactory(), seed=seed)
            for name, tag, _, _, seed in grid]
    result_fleet = runner.run(sims)
    fleet_wall = max(result_fleet.wall_time_s, 1e-9)
    fleet_events = sum(int(f.n_events) for f in result_fleet.finals)

    # per-sim outcome cross-check (decision-level equality is pinned by
    # the fleet tests; the bench refuses to report numbers for diverging
    # simulations)
    row_events: Dict[str, int] = {tag: 0 for tag, _, _ in rows}
    for i, want in enumerate(host_outcomes):
        s = result_fleet.summary(i)
        got = {"name": want["name"], "events": s["events"],
               "completed": s["completed"], "rejected": s["rejected"],
               "sim_end_time": s["sim_end_time"]}
        assert got == want, f"engine divergence: {got} != {want}"
        row_events[grid[i][1]] += s["events"]

    # per-row throughput: host walls are measured per row; the single
    # batched fleet launch is amortized uniformly over its sims
    per_row = []
    for tag, _, _ in rows:
        h_wall = max(host_row_wall[tag], 1e-9)
        f_wall = max(fleet_wall * n_seeds / len(grid), 1e-9)
        per_row.append({
            "dispatcher": tag,
            "engine": "fleet",
            "events": row_events[tag],
            "host_events_per_s": round(row_events[tag] / h_wall, 1),
            "fleet_events_per_s": round(row_events[tag] / f_wall, 1),
        })

    speedup = (fleet_events / fleet_wall) / (host_events / host_wall)
    result = {
        "benchmark": "fleet",
        "quick": quick,
        "grid": {"dispatchers": [t for t, _, _ in rows],
                 "seeds": n_seeds, "base_seed": BASE_SEED},
        "n_sims": len(grid),
        "jobs_per_sim": n_jobs,
        "fleet_covered_fraction": round(
            (len(rows) - len(fallbacks)) / len(rows), 3),
        "rows": per_row,
        "host": {
            "wall_time_s": round(host_wall, 3),
            "events": host_events,
            "events_per_s": round(host_events / host_wall, 1),
            "sims_per_s": round(len(grid) / host_wall, 2),
        },
        "fleet": {
            "wall_time_s": round(fleet_wall, 3),
            "compile_time_s": round(result_fleet.compile_time_s, 3),
            "compile_cache_hit": result_fleet.cache_hit,
            # cost-class launch split (EBF lanes vs blocking lanes);
            # per-launch walls show where time goes
            "launches": result_fleet.launches,
            "events": fleet_events,
            "events_per_s": round(fleet_events / fleet_wall, 1),
            "sims_per_s": round(len(grid) / fleet_wall, 2),
            "n_devices": result_fleet.n_devices,
        },
        "speedup_aggregate_events_per_s": round(speedup, 2),
        "env": bench_metadata(),
    }
    emit(f"fleet/host/{len(grid)}sims",
         1e6 * host_wall / max(host_events, 1),
         f"events_per_s={result['host']['events_per_s']}")
    emit(f"fleet/batched/{len(grid)}sims",
         1e6 * fleet_wall / max(fleet_events, 1),
         f"events_per_s={result['fleet']['events_per_s']},"
         f"compile_s={result['fleet']['compile_time_s']}")
    emit("fleet/speedup_vs_serial_host", speedup,
         f"n_sims={len(grid)},covered={result['fleet_covered_fraction']}")

    path = os.path.join(REPO_ROOT, "BENCH_torch_fleet.json")
    with open(path, "w") as fh:
        json.dump(result, fh, indent=1)
    return result
