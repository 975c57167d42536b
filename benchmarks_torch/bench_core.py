"""Simulation-core throughput benchmark — the perf trajectory of the
event loop itself (events/s + peak RSS) across workload sizes.

All probes run seeded :class:`SyntheticWorkload` streams through the
public ``Simulator`` API, in two scenarios:

* ``steady`` — arrivals sized so a 192-node system keeps up and the
  queue stays shallow (depth ~1): per-event fixed costs dominate.  Two
  engines per size: ``REJECT`` (the paper's simulator-performance probe,
  §6.2 — isolates the core from dispatching) and ``FIFO-FF`` (full
  dispatch/run/release path).  Runs the whole workload at 10k/100k/1M
  jobs — this is also the peak-RSS flatness check (row recycling).
* ``contended`` — arrivals outpace the system so a multi-thousand-job
  queue forms (the regime real HPC schedulers live in, and the exact
  O(queue)-Python-per-event pathology the array-native JobTable core
  removes).  Measured over a fixed ``max_events`` window of the 100k-job
  stream — this is the headline cell.

The core and its numpy dispatchers are host code: this mode measures the
host's CPU, not a card.  Writes ``BENCH_torch_core.json`` at the repo
root.  If a ``BENCH_torch_core_baseline.json`` (an earlier measurement of
the same cells by this package) is present, per-cell
``speedup_vs_baseline`` is computed from it — this is how the perf
trajectory is tracked across changes.

    PYTHONPATH=src python -m benchmarks_torch.run --core           # full sweep
    PYTHONPATH=src python -m benchmarks_torch.run --core --quick   # 10k + contended
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

from repro_torch.core.job import JobFactory
from repro_torch.core.simulator import Simulator
from repro_torch.workloads.synthetic import SyntheticWorkload

from .common import bench_metadata, emit

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIZES_FULL = (10_000, 100_000, 1_000_000)
SIZES_QUICK = (10_000,)
CONTENDED_JOBS = 100_000
CONTENDED_EVENTS = 6_000

SYSTEM = {"groups": {"n": {"core": 4, "mem": 1024}}, "nodes": {"n": 192}}


def _workload(n_jobs: int, mean_interarrival_s: float) -> SyntheticWorkload:
    return SyntheticWorkload(
        n_jobs, seed=17, mean_interarrival_s=mean_interarrival_s,
        duration_median_s=450.0, duration_sigma=0.9,
        node_weights={1: 0.6, 2: 0.25, 4: 0.15},
        resources={"core": (1, 4), "mem": (64, 1024)})


def steady_workload(n_jobs: int) -> SyntheticWorkload:
    # ~45s inter-arrival: the system keeps up, queue depth ~1
    return _workload(n_jobs, 45.0)


def contended_workload(n_jobs: int) -> SyntheticWorkload:
    # ~2.6s inter-arrival: sustained overload, queue depth in the 1000s
    return _workload(n_jobs, 2.6)


def _probe(scenario: str, engine: str, n_jobs: int, out_dir: str,
           max_events: Optional[int] = None) -> Dict:
    from repro_torch.core.dispatchers import (FirstFit, FirstInFirstOut,
                                              RejectAll)
    sched = RejectAll() if engine == "REJECT" else FirstInFirstOut(FirstFit())
    workload = steady_workload(n_jobs) if scenario == "steady" \
        else contended_workload(n_jobs)
    sim = Simulator(workload, SYSTEM, sched,
                    job_factory=JobFactory(), output_dir=out_dir,
                    name=f"core-{scenario}-{engine}-{n_jobs}")
    t0 = time.time()
    sim.start_simulation(write_output=False, bench_sample_every=1000,
                         max_events=max_events)
    wall = max(time.time() - t0, 1e-9)
    s = sim.summary
    return {
        "name": f"{scenario}/{engine}/{n_jobs}",
        "scenario": scenario,
        "engine": engine,
        "jobs": n_jobs,
        "max_events": max_events,
        "events": s["events"],
        "events_per_s": round(s["events"] / wall, 1),
        "wall_time_s": round(wall, 3),
        "completed": s["completed"],
        "rejected": s["rejected"],
        "final_queue": sim.event_manager.n_queued,
        "peak_rss_mb": round(s["mem_max_mb"], 1),
        "sim_end_time": s["sim_end_time"],
    }


def run(out_dir: str, quick: bool = False) -> Dict:
    os.makedirs(out_dir, exist_ok=True)
    sizes = SIZES_QUICK if quick else SIZES_FULL
    _probe("steady", "FIFO-FF", 2000, out_dir)   # warmup cell, discarded
    cells: List[Dict] = []
    # probe order mirrors the reference's baseline run exactly
    cells.append(_probe("contended", "FIFO-FF", CONTENDED_JOBS, out_dir,
                        max_events=CONTENDED_EVENTS))
    for n_jobs in sizes:
        for engine in ("REJECT", "FIFO-FF"):
            cells.append(_probe("steady", engine, n_jobs, out_dir))
    for r in cells:
        emit(f"core/{r['name']}",
             1e6 * r["wall_time_s"] / max(r["events"], 1),
             f"events_per_s={r['events_per_s']},"
             f"peak_rss_mb={r['peak_rss_mb']}")

    result = {
        "benchmark": "core",
        "sizes": list(sizes),
        "headline_cell": f"contended/FIFO-FF/{CONTENDED_JOBS}",
        "cells": cells,
        "env": bench_metadata(),
    }

    base_path = os.path.join(REPO_ROOT, "BENCH_torch_core_baseline.json")
    if os.path.exists(base_path):
        with open(base_path) as fh:
            baseline = json.load(fh)
        base_cells = {c["name"]: c for c in baseline.get("cells", [])}
        speedups = {}
        for c in cells:
            b = base_cells.get(c["name"])
            if b and b["events_per_s"] > 0:
                speedups[c["name"]] = round(
                    c["events_per_s"] / b["events_per_s"], 2)
                emit(f"core/speedup/{c['name']}", speedups[c["name"]],
                     "vs_baseline")
        result["baseline_events_per_s"] = {
            name: c["events_per_s"] for name, c in base_cells.items()}
        result["speedup_vs_baseline"] = speedups

    path = os.path.join(REPO_ROOT, "BENCH_torch_core.json")
    with open(path, "w") as fh:
        json.dump(result, fh, indent=1)
    return result
