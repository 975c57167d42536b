"""Heterogeneous-system simulation (paper §7.1's Eurora pointer, [30]).

Eurora-like system: two node groups — CPU nodes and GPU/MIC-accelerated
nodes — with jobs that request accelerators.  Exercises AccaSim's
heterogeneous-resource representation (node groups with different
resource-type vectors) plus the data-driven EBF and the power-capped
dispatcher from `repro_torch.core.dispatchers.advanced`.

    python examples_torch/heterogeneous_eurora.py
"""
import json
import os
import random
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import Job, PowerModel, Simulator
from repro_torch.core.dispatchers import (BestFit, EasyBackfilling,
                                          EnergyCappedScheduler,
                                          WalltimeCorrectedEBF)
from repro_torch.experimentation import metrics
from repro_torch.experimentation.plot_factory import utilization_heatmap

# Eurora-like: 32 CPU-only nodes + 32 GPU nodes + 16 MIC nodes
EURORA = {
    "groups": {
        "cpu":  {"core": 16, "mem": 16384, "gpu": 0, "mic": 0},
        "gpu":  {"core": 16, "mem": 16384, "gpu": 2, "mic": 0},
        "mic":  {"core": 16, "mem": 16384, "gpu": 0, "mic": 2},
    },
    "nodes": {"cpu": 32, "gpu": 32, "mic": 16},
}

WATTS = {"core": 12.0, "gpu": 225.0, "mic": 180.0}


def make_jobs(n=2500, seed=3):
    rng = random.Random(seed)
    t = 0
    jobs = []
    for i in range(n):
        t += int(rng.expovariate(1 / 22.0)) + 1
        kind = rng.random()
        req = {"core": rng.choice([1, 2, 4, 8, 16]), "mem": rng.choice([512, 2048, 8192])}
        if kind < 0.25:
            req["gpu"] = rng.choice([1, 2])
        elif kind < 0.35:
            req["mic"] = rng.choice([1, 2])
        dur = int(rng.lognormvariate(6.8, 1.3)) + 1
        jobs.append(Job(
            id=str(i), user_id=rng.randint(1, 25), submission_time=t,
            duration=dur,
            # users overestimate 2-6x: the data-driven EBF's opportunity
            expected_duration=min(dur * rng.randint(2, 6) + 120, 4 * 86400),
            requested_nodes=rng.choice([1, 1, 1, 2, 4]),
            requested_resources=req))
    return jobs


def main():
    out_dir = "results/heterogeneous"
    rows = {}
    for name, sched in [
        ("EBF-BF", EasyBackfilling(BestFit())),
        ("dEBF-BF (walltime-corrected)", WalltimeCorrectedEBF(BestFit())),
        ("ECAP(EBF) 18kW", EnergyCappedScheduler(
            EasyBackfilling(BestFit()), WATTS, cap_watts=18_000.0)),
    ]:
        pm = PowerModel(WATTS, idle_node_watts=80.0)
        sim = Simulator(make_jobs(), EURORA, sched, output_dir=out_dir,
                        name=name.split()[0])
        out = sim.start_simulation(additional_data=[pm])
        sl = metrics.percentiles(metrics.slowdowns(out))
        rows[name] = {
            "slowdown_mean": round(sl["mean"], 2),
            "slowdown_p95": round(sl["p95"], 2),
            "makespan_h": round(sim.summary["sim_end_time"] / 3600, 1),
            "avg_power_kw": round(pm.energy_joules / max(sim.summary["sim_end_time"], 1) / 1e3, 1),
            "deferred": getattr(sched, "deferred", 0),
        }
        if name.startswith("EBF"):
            png = utilization_heatmap(out, 80, os.path.join(out_dir, "heatmap.png"))
    print(json.dumps(rows, indent=1))
    print("utilization heatmap:", os.path.join(out_dir, "heatmap.png"))


if __name__ == "__main__":
    main()
