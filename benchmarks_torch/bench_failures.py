"""Failure-aware simulation throughput (DESIGN.md §9).

Two questions, one JSON:

* what does the native FAIL/REPAIR event path cost at scale?  The
  ``host_scale`` cell runs a >=100k-job FIFO-FF simulation (10k with
  ``--quick``) with a seeded per-node failure schedule — preempt +
  requeue victims with checkpoint credit, quarantine-masked dispatch —
  and reports events/s next to the failure counters, comparable to the
  ``BENCH_torch_core`` steady cells of the same size (host code: the
  host's CPU).
* does the fleet engine stay trustworthy under failures?  The
  ``crosscheck`` grid (FIFO-FF + EBF-FF x seeds) runs the identical
  failure scenario on both engines and REFUSES to report fleet numbers
  unless per-sim outcomes AND failure counters match exactly (decision
  bit-identity is pinned by the failure tests).

The fleet runs on ``device``: None means the card (and raises without
one), ``"cpu"`` runs the plain PyTorch version.  Writes
``BENCH_torch_failures.json`` at the repo root.

    PYTHONPATH=src python -m benchmarks_torch.run --failures           # full
    PYTHONPATH=src python -m benchmarks_torch.run --failures --quick   # CI smoke
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List

from repro_torch.cluster import FailureInjector
from repro_torch.cluster.failures import CheckpointRestartPolicy
from repro_torch.core.dispatchers import (EasyBackfilling, FirstFit,
                                          FirstInFirstOut)
from repro_torch.core.job import JobFactory
from repro_torch.core.simulator import Simulator
from repro_torch.fleet import FleetRunner, dispatch_code
from repro_torch.workloads.synthetic import SyntheticWorkload

from .common import bench_metadata, emit

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# scale cell: the BENCH_torch_core steady system, so events/s is comparable
SCALE_SYSTEM = {"groups": {"n": {"core": 4, "mem": 1024}},
                "nodes": {"n": 192}}
SCALE_JOBS_FULL = 100_000
SCALE_JOBS_QUICK = 10_000

# crosscheck grid: the golden-trace system of the failure tests
GRID_SYSTEM = {"groups": {"a": {"core": 4, "mem": 1024},
                          "b": {"core": 8, "mem": 2048}},
               "nodes": {"a": 6, "b": 4}}
GRID = [("FIFO-FF", FirstInFirstOut, FirstFit),
        ("EBF-FF", EasyBackfilling, FirstFit)]
GRID_JOBS_FULL, GRID_SEEDS_FULL = 400, 2
GRID_JOBS_QUICK, GRID_SEEDS_QUICK = 120, 1
BASE_SEED = 29

QUARANTINE_S = 1800
CKPT_EVERY_S = 600


def _steady_workload(n_jobs: int) -> SyntheticWorkload:
    return SyntheticWorkload(
        n_jobs, seed=17, mean_interarrival_s=45.0, duration_median_s=450.0,
        duration_sigma=0.9, node_weights={1: 0.6, 2: 0.25, 4: 0.15},
        resources={"core": (1, 4), "mem": (64, 1024)})


def _grid_workload(n_jobs: int, seed: int) -> SyntheticWorkload:
    return SyntheticWorkload(
        n_jobs, seed=seed, mean_interarrival_s=25.0,
        duration_median_s=900.0, duration_sigma=1.1,
        node_weights={1: 0.5, 2: 0.3, 4: 0.2},
        resources={"core": (1, 4), "mem": (64, 1024)})


def _scale_cell(n_jobs: int, out_dir: str) -> Dict:
    """Host FIFO-FF at scale with ~3 failures per node over the span."""
    span_s = int(n_jobs * 45)
    inj = FailureInjector(192, mtbf_s=span_s / 3.0, repair_s=3600.0,
                          horizon_s=span_s, seed=5)
    sim = Simulator(_steady_workload(n_jobs), SCALE_SYSTEM,
                    FirstInFirstOut(FirstFit()), job_factory=JobFactory(),
                    output_dir=out_dir, name=f"failbench-{n_jobs}",
                    failures=inj, checkpoint=CheckpointRestartPolicy(
                        CKPT_EVERY_S), quarantine_s=QUARANTINE_S)
    t0 = time.time()
    sim.start_simulation(write_output=False, bench_sample_every=1000)
    wall = max(time.time() - t0, 1e-9)
    s = sim.summary
    assert s["failures"]["requeued_jobs"] > 0, \
        "scale cell exercised no requeue — scenario too mild to measure"
    return {
        "name": f"failures/FIFO-FF/{n_jobs}",
        "jobs": n_jobs,
        "failure_events": int(inj.times.shape[0]),
        "events": s["events"],
        "events_per_s": round(s["events"] / wall, 1),
        "wall_time_s": round(wall, 3),
        "completed": s["completed"],
        "rejected": s["rejected"],
        "failures": dict(s["failures"]),
        "peak_rss_mb": round(s["mem_max_mb"], 1),
        "sim_end_time": s["sim_end_time"],
    }


def run(out_dir: str, quick: bool = False, device=None) -> Dict:
    os.makedirs(out_dir, exist_ok=True)
    runner = FleetRunner(device=device)
    n_scale = SCALE_JOBS_QUICK if quick else SCALE_JOBS_FULL
    n_grid = GRID_JOBS_QUICK if quick else GRID_JOBS_FULL
    n_seeds = GRID_SEEDS_QUICK if quick else GRID_SEEDS_FULL

    scale = _scale_cell(n_scale, out_dir)
    emit(scale["name"], 1e6 * scale["wall_time_s"] / max(scale["events"], 1),
         f"events_per_s={scale['events_per_s']},"
         f"requeued={scale['failures']['requeued_jobs']}")

    # --- host-vs-fleet crosscheck grid under the same failure trace ---
    injector = lambda: FailureInjector(10, mtbf_s=4000.0, repair_s=900.0,
                                       horizon_s=6000, seed=3)
    grid = [(f"{tag}-s{BASE_SEED + i}", tag, s_cls, a_cls, BASE_SEED + i)
            for tag, s_cls, a_cls in GRID for i in range(n_seeds)]

    host_outcomes: List[Dict] = []
    t0 = time.time()
    for name, tag, s_cls, a_cls, seed in grid:
        sim = Simulator(_grid_workload(n_grid, seed), GRID_SYSTEM,
                        s_cls(a_cls()), job_factory=JobFactory(),
                        output_dir=out_dir, name=f"failbench-{name}",
                        failures=injector(),
                        checkpoint=CheckpointRestartPolicy(CKPT_EVERY_S),
                        quarantine_s=QUARANTINE_S)
        sim.start_simulation(write_output=False)
        s = sim.summary
        host_outcomes.append({
            "name": name, "events": s["events"],
            "completed": s["completed"], "rejected": s["rejected"],
            "sim_end_time": s["sim_end_time"],
            "failures": dict(s["failures"])})
    host_wall = max(time.time() - t0, 1e-9)
    host_events = sum(o["events"] for o in host_outcomes)

    codes = {tag: dispatch_code(s_cls(a_cls())) for tag, s_cls, a_cls in GRID}
    fallbacks = [tag for tag, pair in codes.items() if pair is None]
    assert not fallbacks, f"host fallback rows: {fallbacks}"
    sims = [FleetRunner.build(name, _grid_workload(n_grid, seed),
                              GRID_SYSTEM, codes[tag][0],
                              alloc_id=codes[tag][1],
                              job_factory=JobFactory(), seed=seed,
                              failures=injector(),
                              quarantine_s=QUARANTINE_S,
                              ckpt_every_s=CKPT_EVERY_S)
            for name, tag, _, _, seed in grid]
    result_fleet = runner.run(sims)
    fleet_wall = max(result_fleet.wall_time_s, 1e-9)
    fleet_events = sum(int(f.n_events) for f in result_fleet.finals)

    for i, want in enumerate(host_outcomes):
        s = result_fleet.summary(i)
        got = {"name": want["name"], "events": s["events"],
               "completed": s["completed"], "rejected": s["rejected"],
               "sim_end_time": s["sim_end_time"],
               "failures": dict(s["failures"])}
        assert got == want, f"engine divergence under failures: " \
            f"{got} != {want}"

    result = {
        "benchmark": "failures",
        "quick": quick,
        "scale_cell": scale,
        "crosscheck": {
            "grid": {"dispatchers": [t for t, _, _ in GRID],
                     "seeds": n_seeds, "base_seed": BASE_SEED},
            "n_sims": len(grid),
            "jobs_per_sim": n_grid,
            "outcomes": host_outcomes,
            "host": {"wall_time_s": round(host_wall, 3),
                     "events": host_events,
                     "events_per_s": round(host_events / host_wall, 1)},
            "fleet": {"wall_time_s": round(fleet_wall, 3),
                      "compile_time_s": round(
                          result_fleet.compile_time_s, 3),
                      "events": fleet_events,
                      "events_per_s": round(fleet_events / fleet_wall, 1),
                      "n_devices": result_fleet.n_devices},
        },
        "quarantine_s": QUARANTINE_S,
        "ckpt_every_s": CKPT_EVERY_S,
        "env": bench_metadata(),
    }
    emit(f"failures/crosscheck/host/{len(grid)}sims",
         1e6 * host_wall / max(host_events, 1),
         f"events_per_s={result['crosscheck']['host']['events_per_s']}")
    emit(f"failures/crosscheck/fleet/{len(grid)}sims",
         1e6 * fleet_wall / max(fleet_events, 1),
         f"events_per_s={result['crosscheck']['fleet']['events_per_s']},"
         f"compile_s={result['crosscheck']['fleet']['compile_time_s']}")

    path = os.path.join(REPO_ROOT, "BENCH_torch_failures.json")
    with open(path, "w") as fh:
        json.dump(result, fh, indent=1)
    return result
