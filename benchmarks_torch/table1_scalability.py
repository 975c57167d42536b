"""Paper Table 1: simulator scalability (CPU time + memory vs workload
size) with the rejecting dispatcher isolating the simulator core.

The paper's datasets (Seth 203k / RICC 448k / MetaCentrum 5.7M jobs) are
not redistributable offline; we substitute synthetic workloads of
matching magnitudes (medium / large / very large) — the measured quantity
(core event-loop cost + RSS flatness from incremental loading) is the
same.  BENCH_SCALE=11 reproduces paper-scale MetaCentrum (5.5M jobs).
The simulator core is host code: this mode measures the host's CPU, not
a card.
"""
from __future__ import annotations

import json
import os
import time

from repro_torch.core import Simulator
from repro_torch.core.dispatchers import RejectAll

from .common import SETH, emit, scaled, seth_jobs

SIZES = {"medium(seth-like)": 50_000, "large(ricc-like)": 110_000,
         "xlarge(mc-like)": 500_000}


def run(out_dir: str = "results/bench") -> dict:
    os.makedirs(out_dir, exist_ok=True)
    rows = {}
    for label, base_n in SIZES.items():
        n = scaled(base_n)
        t0 = time.process_time()
        sim = Simulator(seth_jobs(n, seed=1), SETH, RejectAll(),
                        output_dir=out_dir, name=f"t1-{label}",
                        lookahead_jobs=4096)
        sim.start_simulation(write_output=False, bench_sample_every=64)
        cpu = time.process_time() - t0
        rows[label] = {
            "jobs": n,
            "cpu_s": round(cpu, 2),
            "mem_avg_mb": round(sim.summary["mem_avg_mb"], 1),
            "mem_max_mb": round(sim.summary["mem_max_mb"], 1),
            "us_per_job": 1e6 * cpu / n,
        }
        emit(f"table1/{label}", rows[label]["us_per_job"],
             f"jobs={n};mem_max={rows[label]['mem_max_mb']}MB")
    with open(os.path.join(out_dir, "table1.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    return rows


if __name__ == "__main__":
    print(json.dumps(run(), indent=1))
