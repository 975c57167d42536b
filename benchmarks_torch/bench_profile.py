"""Telemetry overhead + per-phase profile of the fleet engine.

Runs the ``BENCH_torch_fleet`` Table-2 grid twice on the fleet engine —
telemetry OFF (stride 0: the ``fleet_engine`` kernel built without the
telemetry machinery) and telemetry ON (device-resident buffers at the
default stride, the telemetry build) — and reports:

* compile (kernel library build or load) wall vs run wall for both
  configurations;
* the per-launch cost-class breakdown (EBF vs blocking lanes);
* per-phase trip attribution from the decoded phase counters: where
  each dispatcher row spends its machinery trips (greedy dispatch
  probes, shadow-walk iterations, backfill admits/misfit skips,
  failure drains) instead of one aggregate wall number;
* the telemetry events/s overhead — the run FAILS (non-zero exit) if
  telemetry-on throughput regresses more than ``BENCH_TELE_MAX_OVERHEAD``
  (default 15%) vs telemetry-off, each config measured as the best of
  two warm launches (the build is paid outside the timed window).

The fleet runs on ``device``: None means the card (and raises without
one), ``"cpu"`` runs the plain PyTorch version.  Writes
``BENCH_torch_profile.json`` at the repo root, a human-readable
``profile_report.txt`` plus one example structured telemetry trace
(JSONL) under the output dir — the CI artifacts.

    PYTHONPATH=src python -m benchmarks_torch.run --profile           # full grid
    PYTHONPATH=src python -m benchmarks_torch.run --profile --quick   # CI smoke
"""
from __future__ import annotations

import json
import os
import sys
from typing import Dict

from repro_torch.core.job import JobFactory
from repro_torch.fleet import FleetRunner, dispatch_code

from .bench_fleet import (BASE_SEED, GRID, GRID_QUICK, JOBS_FULL,
                          JOBS_QUICK, N_SEEDS_FULL, N_SEEDS_QUICK, SYSTEM,
                          _workload)
from .common import bench_metadata, emit

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEFAULT_STRIDE = 16
MAX_OVERHEAD = float(os.environ.get("BENCH_TELE_MAX_OVERHEAD", "0.15"))


def _build_grid(rows, n_seeds: int, n_jobs: int, stride: int):
    codes = {tag: dispatch_code(s_cls(a_cls())) for tag, s_cls, a_cls in rows}
    sims, tags = [], []
    for tag, _, _ in rows:
        for i in range(n_seeds):
            seed = BASE_SEED + i
            sims.append(FleetRunner.build(
                f"{tag}-s{seed}", _workload(n_jobs, seed), SYSTEM,
                codes[tag][0], alloc_id=codes[tag][1],
                job_factory=JobFactory(), seed=seed,
                telemetry_stride=stride))
            tags.append(tag)
    return sims, tags


def _timed_run(runner: FleetRunner, rows, n_seeds: int, n_jobs: int,
               stride: int):
    """Best-of-two warm launches (sims rebuilt per attempt — a final
    state must never be re-advanced); returns the faster result +
    (compile_s, run_s, events)."""
    best = None
    compile_s = 0.0
    for _ in range(2):
        sims, tags = _build_grid(rows, n_seeds, n_jobs, stride)
        res = runner.run(sims)
        compile_s += res.compile_time_s
        if best is None or res.wall_time_s < best[0].wall_time_s:
            best = (res, tags)
    res, tags = best
    events = sum(int(f.n_events) for f in res.finals)
    return res, tags, compile_s, res.wall_time_s, events


def run(out_dir: str, quick: bool = False, device=None) -> Dict:
    os.makedirs(out_dir, exist_ok=True)
    rows = GRID_QUICK if quick else GRID
    n_seeds = N_SEEDS_QUICK if quick else N_SEEDS_FULL
    n_jobs = JOBS_QUICK if quick else JOBS_FULL

    runner = FleetRunner(device=device)
    res_off, _, comp_off, wall_off, ev_off = _timed_run(
        runner, rows, n_seeds, n_jobs, stride=0)
    res_on, tags, comp_on, wall_on, ev_on = _timed_run(
        runner, rows, n_seeds, n_jobs, stride=DEFAULT_STRIDE)
    assert ev_on == ev_off, "telemetry changed the event count"

    eps_off = ev_off / max(wall_off, 1e-9)
    eps_on = ev_on / max(wall_on, 1e-9)
    overhead = max(0.0, 1.0 - eps_on / eps_off)

    # per-phase trip attribution, aggregated per dispatcher row
    attribution: Dict[str, Dict[str, int]] = {}
    for i, tag in enumerate(tags):
        tele = res_on.telemetry(i)
        acc = attribution.setdefault(tag, {})
        for k, v in tele.phase_counters.items():
            acc[k] = acc.get(k, 0) + v

    result = {
        "benchmark": "profile",
        "quick": quick,
        "grid": {"dispatchers": [t for t, _, _ in rows], "seeds": n_seeds},
        "n_sims": len(tags),
        "jobs_per_sim": n_jobs,
        "telemetry_stride": DEFAULT_STRIDE,
        "events": ev_on,
        "telemetry_off": {
            "compile_time_s": round(comp_off, 3),
            "run_wall_s": round(wall_off, 4),
            "events_per_s": round(eps_off, 1),
            "launches": res_off.launches,
        },
        "telemetry_on": {
            "compile_time_s": round(comp_on, 3),
            "run_wall_s": round(wall_on, 4),
            "events_per_s": round(eps_on, 1),
            "launches": res_on.launches,
            "n_samples": sum(res_on.telemetry(i).n_samples
                             for i in range(len(tags))),
        },
        "phase_attribution": attribution,
        "overhead_fraction": round(overhead, 4),
        "max_overhead_fraction": MAX_OVERHEAD,
        "overhead_ok": overhead <= MAX_OVERHEAD,
        "env": bench_metadata(),
    }

    trace_path = res_on.write_telemetry(out_dir, 0)
    report_path = os.path.join(out_dir, "profile_report.txt")
    with open(report_path, "w") as fh:
        fh.write(_report(result))
    json_path = os.path.join(REPO_ROOT, "BENCH_torch_profile.json")
    with open(json_path, "w") as fh:
        json.dump(result, fh, indent=1)

    emit("profile/telemetry_off", 1e6 * wall_off / max(ev_off, 1),
         f"events_per_s={result['telemetry_off']['events_per_s']}")
    emit("profile/telemetry_on", 1e6 * wall_on / max(ev_on, 1),
         f"events_per_s={result['telemetry_on']['events_per_s']},"
         f"stride={DEFAULT_STRIDE}")
    emit("profile/overhead_fraction", overhead,
         f"budget={MAX_OVERHEAD},ok={result['overhead_ok']}")
    print(f"# profile report: {report_path}", file=sys.stderr)
    print(f"# telemetry trace: {trace_path}", file=sys.stderr)

    if not result["overhead_ok"]:
        sys.exit(f"telemetry overhead {overhead:.1%} exceeds the "
                 f"{MAX_OVERHEAD:.0%} budget "
                 f"({eps_on:.0f} vs {eps_off:.0f} events/s)")
    return result


def _report(r: Dict) -> str:
    lines = [
        "fleet engine profile (telemetry layer, DESIGN.md §10)",
        "=" * 56,
        f"grid: {r['grid']['dispatchers']} x {r['grid']['seeds']} seeds "
        f"({r['n_sims']} sims, {r['jobs_per_sim']} jobs each, "
        f"{r['events']} events)",
        "",
        "compile vs run wall:",
        f"  telemetry off: compile {r['telemetry_off']['compile_time_s']}s, "
        f"run {r['telemetry_off']['run_wall_s']}s "
        f"({r['telemetry_off']['events_per_s']} events/s)",
        f"  telemetry on : compile {r['telemetry_on']['compile_time_s']}s, "
        f"run {r['telemetry_on']['run_wall_s']}s "
        f"({r['telemetry_on']['events_per_s']} events/s, "
        f"stride {r['telemetry_stride']}, "
        f"{r['telemetry_on']['n_samples']} samples)",
        "",
        "per-launch cost classes (telemetry on):",
    ]
    for l in r["telemetry_on"]["launches"]:
        lines.append(f"  {l['cost_class']:>8}: {l['n_sims']} sims, "
                     f"{l['events']} events, wall {l['wall_time_s']}s, "
                     f"cache_hit={l['cache_hit']}")
    lines += ["", "per-phase trip attribution (summed over seeds):"]
    for tag, acc in r["phase_attribution"].items():
        parts = ", ".join(f"{k}={v}" for k, v in acc.items() if v)
        lines.append(f"  {tag:>8}: {parts or 'none'}")
    lines += ["",
              f"telemetry overhead: {r['overhead_fraction']:.1%} "
              f"(budget {r['max_overhead_fraction']:.0%}) -> "
              f"{'OK' if r['overhead_ok'] else 'FAIL'}", ""]
    return "\n".join(lines)
