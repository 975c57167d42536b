"""Workload generation examples.

Two sources of synthetic workloads:

* ``WorkloadGenerator`` (paper Fig. 6): mimic a REAL trace's empirical
  distributions and emit a synthetic SWF with modified system
  assumptions;
* ``SyntheticWorkload``: parametric first-principles generation (Poisson
  arrivals, lognormal durations, configurable request distributions) —
  no input trace needed; records stream straight into the simulator's
  JobTable rows (DESIGN.md §4), so nothing is ever materialized twice.

Host only: no kernel runs here.

    PYTHONPATH=src python examples_torch/workload_generation.py [n_jobs]
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from repro_torch.core.job import JobFactory
from repro_torch.core.simulator import Simulator
from repro_torch.core.dispatchers import EasyBackfilling, FirstFit
from repro_torch.generator import WorkloadGenerator
from repro_torch.workloads import SWFWriter, SyntheticWorkload
from benchmarks_torch.common import SETH, seth_jobs

OUT = "results/workload_generation"


def parametric_demo(n: int) -> None:
    """SyntheticWorkload -> Simulator, no SWF file in between."""
    workload = SyntheticWorkload(
        n, seed=11, mean_interarrival_s=30.0,
        duration_median_s=1200.0, duration_sigma=1.2,
        node_weights={1: 0.5, 2: 0.3, 4: 0.15, 8: 0.05},
        resources={"core": (1, 4), "mem": (128, 1024)})
    sim = Simulator(workload, SETH, EasyBackfilling(FirstFit()),
                    job_factory=JobFactory(), output_dir=OUT,
                    name="synthetic-ebf")
    sim.start_simulation(write_output=False)
    s = sim.summary
    print(json.dumps({
        "synthetic_jobs": n,
        "completed": s["completed"],
        "events": s["events"],
        "makespan_h": round(s["sim_end_time"] / 3600, 1),
        "mem_max_mb": round(s["mem_max_mb"], 1),
    }, indent=1))


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 5000
    os.makedirs(OUT, exist_ok=True)
    # the "real" trace to mimic
    real_path = os.path.join(OUT, "real_workload.swf")
    SWFWriter().write(
        iter({"id": i + 1, "submit": j.submission_time,
              "duration": j.duration,
              "expected_duration": j.expected_duration,
              "requested_processors": j.requested_resources["core"]
              * j.requested_nodes,
              "requested_memory": j.requested_resources.get("mem", 0),
              "user": j.user_id, "status": 1}
             for i, j in enumerate(seth_jobs(n, seed=9))), real_path)

    performance = {"core": 1.667}                      # GFLOPS per core
    request_limits = {"min": {"core": 1, "mem": 256},
                      "max": {"core": 8, "mem": 1024}}

    gen = WorkloadGenerator(real_path, SETH, performance, request_limits)
    jobs = gen.generate_jobs(n, os.path.join(OUT, "new_workload.swf"))
    print(json.dumps({
        "generated": len(jobs),
        "output": os.path.join(OUT, "new_workload.swf"),
        "span_days": round((jobs[-1]["submit"] - jobs[0]["submit"]) / 86400, 1),
        "fitted_v_max_s": gen.v_max0,
        "work_logmean": round(gen.work_mu, 2),
    }, indent=1))
    parametric_demo(min(n, 2000))


if __name__ == "__main__":
    main()
