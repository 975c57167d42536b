"""Batched vs per-job dispatch benchmark — seeds the perf trajectory.

Runs a queue×node sweep of the same synthetic workload through three
engines:

* ``numpy``    — the reference allocators (no kernels at all);
* ``per-job``  — ``VectorizedAllocator(batched=False)``: one
  ``alloc_score`` launch per probed job (the pre-redesign O(queue) path);
* ``batched``  — ``VectorizedAllocator()``: one ``alloc_score_batch``
  launch per dispatch event (the DispatchContext/DispatchPlan path).

Writes ``BENCH_torch_dispatch.json`` at the repo root with events/s,
kernel launches/event and dispatch_time_s per engine, plus the headline
``speedup_batched_vs_per_job``.  The vectorized engines run on
``device``: None means the card (and raises without one), ``"cpu"`` runs
the kernels' plain PyTorch versions; ``"mode"`` records that device.
"""
from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Tuple

from repro_torch.core.job import Job
from repro_torch.core.simulator import Simulator
from repro_torch.kernels.ops import resolve_device

from .common import bench_metadata, emit

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _system(n_nodes: int) -> Dict:
    return {"groups": {"n": {"core": 4, "mem": 1024}},
            "nodes": {"n": n_nodes}}


def _jobs(n_jobs: int, seed: int = 13) -> List[Job]:
    """Bursty arrivals: a deep queue forms immediately and stays deep, so
    per-event queue depth (the thing the batched path amortizes) is high."""
    rng = random.Random(seed)
    out = []
    for i in range(n_jobs):
        dur = rng.randint(120, 2400)
        out.append(Job(
            id=str(i), user_id=rng.randint(1, 8),
            submission_time=rng.randint(0, 60),
            duration=dur,
            expected_duration=min(int(dur * rng.uniform(1.0, 2.0)) + 30,
                                  4 * 86400),
            requested_nodes=rng.randint(1, 3),
            requested_resources={"core": rng.randint(1, 4),
                                 "mem": rng.choice([128, 256, 512])}))
    return out


def _run_engine(engine: str, n_nodes: int, n_jobs: int, out_dir: str,
                device=None) -> Dict:
    # EASY backfilling is the queue-scanning dispatcher: the per-job path
    # probes EVERY queued job per event (O(queue) launches), which is the
    # pathology the batched protocol removes — so it is the honest A/B.
    from repro_torch.core.dispatchers import EasyBackfilling, FirstFit
    from repro_torch.core.dispatchers.vectorized import (
        VectorizedAllocator, VectorizedEasyBackfilling)
    if engine == "numpy":
        sched = EasyBackfilling(FirstFit())
    elif engine == "per-job":
        sched = VectorizedEasyBackfilling(
            VectorizedAllocator("FF", batched=False, device=device))
    elif engine == "batched":
        sched = VectorizedEasyBackfilling(
            VectorizedAllocator("FF", device=device))
    else:
        raise KeyError(engine)
    sim = Simulator(_jobs(n_jobs), _system(n_nodes), sched,
                    output_dir=out_dir,
                    name=f"dispatch-{engine}-{n_nodes}x{n_jobs}")
    sim.start_simulation(write_output=False)
    s = sim.summary
    dispatch_s = max(s["dispatch_time_s"], 1e-9)
    return {
        "engine": engine,
        "nodes": n_nodes,
        "jobs": n_jobs,
        "events": s["events"],
        "events_per_s": s["events"] / dispatch_s,
        "dispatch_time_s": round(s["dispatch_time_s"], 4),
        "kernel_launches": s["kernel_launches"],
        "kernel_launches_per_event": round(
            s["kernel_launches_per_event"], 3),
        "completed": s["completed"],
        "sim_end_time": s["sim_end_time"],
    }


def run(out_dir: str, quick: bool = False, device=None) -> Dict:
    os.makedirs(out_dir, exist_ok=True)
    dev = resolve_device(device)
    sweep: List[Tuple[int, int]] = [(64, 256)] if quick else \
        [(32, 128), (64, 256), (128, 512)]
    engines = ("numpy", "per-job", "batched")
    cells = []
    for n_nodes, n_jobs in sweep:
        row = {}
        for engine in engines:
            r = _run_engine(engine, n_nodes, n_jobs, out_dir, dev)
            row[engine] = r
            cells.append(r)
            emit(f"dispatch/{engine}/{n_nodes}x{n_jobs}",
                 1e6 * r["dispatch_time_s"] / max(r["events"], 1),
                 f"launches_per_event={r['kernel_launches_per_event']}")
        # decisions must agree across engines (trace equality is tested
        # elsewhere; the bench cross-checks the aggregate outcome)
        ends = {row[e]["sim_end_time"] for e in engines}
        assert len(ends) == 1, f"engine divergence: {row}"
    head = [c for c in cells if (c["nodes"], c["jobs"]) == sweep[-1]]
    by_engine = {c["engine"]: c for c in head}
    speedup = (by_engine["batched"]["events_per_s"]
               / max(by_engine["per-job"]["events_per_s"], 1e-9))
    result = {
        "benchmark": "dispatch",
        "mode": str(dev),
        "headline": f"{by_engine['batched']['nodes']}x"
                    f"{by_engine['batched']['jobs']}",
        "speedup_batched_vs_per_job": round(speedup, 2),
        "cells": cells,
        "env": bench_metadata(),
    }
    path = os.path.join(REPO_ROOT, "BENCH_torch_dispatch.json")
    with open(path, "w") as fh:
        json.dump(result, fh, indent=1)
    emit("dispatch/speedup_batched_vs_per_job", speedup,
         f"headline={result['headline']}")
    return result
