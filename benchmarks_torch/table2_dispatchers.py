"""Paper Table 2 + Figs 10-13: the 8-dispatcher case study on the
Seth-like system — total/dispatch CPU time, memory, slowdown and queue
distributions, dispatch-time-vs-queue-size scalability.

    PYTHONPATH=src python -m benchmarks_torch.table2_dispatchers

All 8 dispatchers lower onto the fleet engine, so the study is two
``fleet_engine`` launches (blocking, EBF) on the card; ``run(device=
"cpu")`` runs them through the plain PyTorch version instead.  A fleet
row's CPU and dispatch seconds are its launch's wall amortized per sim
(``FleetResult.summary``).  The plots need matplotlib;
``produce_plots=False`` leaves them out where it is not installed."""
from __future__ import annotations

import json
import os

from repro_torch.core.dispatchers import (BestFit, EasyBackfilling, FirstFit,
                                          FirstInFirstOut, LongestJobFirst,
                                          ShortestJobFirst)
from repro_torch.experimentation import Experiment, metrics

from .common import SETH, emit, scaled, seth_jobs


def run(out_dir: str = "results/bench", n_jobs: int = None,
        device=None, produce_plots: bool = True) -> dict:
    n = n_jobs or scaled(8_000)
    exp = Experiment("table2", list(seth_jobs(n, seed=2)), SETH,
                     output_dir=out_dir, device=device)
    exp.gen_dispatchers(
        [FirstInFirstOut, ShortestJobFirst, LongestJobFirst, EasyBackfilling],
        [FirstFit, BestFit])
    results = exp.run_simulation(produce_plots=produce_plots)

    rows = {}
    for name, res in results.items():
        s = res["summaries"][0]
        sl = metrics.percentiles(metrics.slowdowns(res["output"]))
        q = metrics.percentiles(metrics.bench_series(res["bench"])["queue"])
        rows[name] = {
            "total_cpu_s": round(s["cpu_time_s"], 2),
            "dispatch_cpu_s": round(s["dispatch_time_s"], 2),
            "mem_avg_mb": round(s["mem_avg_mb"], 1),
            "mem_max_mb": round(s["mem_max_mb"], 1),
            "slowdown_p50": round(sl["p50"], 2),
            "slowdown_mean": round(sl["mean"], 2),
            "queue_p50": q["p50"],
            "queue_mean": round(q["mean"], 1),
            "makespan": s["sim_end_time"],
        }
        emit(f"table2/{name}", 1e6 * s["dispatch_time_s"] / max(s["events"], 1),
             f"slowdown_mean={rows[name]['slowdown_mean']};"
             f"queue_mean={rows[name]['queue_mean']}")
    with open(os.path.join(out_dir, "table2", "table2.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    return rows


if __name__ == "__main__":
    print(json.dumps(run(), indent=1))
