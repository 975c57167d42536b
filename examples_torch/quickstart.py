"""Quickstart — the paper's Fig. 4 instantiation, verbatim shape.

    python examples_torch/quickstart.py

Simulates a Seth-like workload under FIFO-FF, then produces the slowdown
plot via the PlotFactory (which needs matplotlib).  Host work only, as
in the reference: the numpy FIFO-FF dispatcher on the host simulator.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.simulator import Simulator
from repro_torch.core.dispatchers import FirstInFirstOut, FirstFit
from repro_torch.experimentation.plot_factory import PlotFactory
from repro_torch.generator import WorkloadGenerator
from repro_torch.workloads import SWFWriter

OUT = "results/quickstart"


def make_inputs():
    """Create a small SWF workload + system config on disk (stand-ins for
    the paper's Seth trace, which is not redistributable)."""
    os.makedirs(OUT, exist_ok=True)
    sys_cfg = {"groups": {"seth": {"core": 4, "mem": 1024}},
               "nodes": {"seth": 120}}
    with open(f"{OUT}/sys_config.json", "w") as fh:
        json.dump(sys_cfg, fh)
    import random
    rng = random.Random(0)
    t = 0
    recs = []
    for i in range(3000):
        t += rng.randint(1, 240)
        procs = rng.choice([1, 1, 2, 4, 8])
        recs.append({"id": i + 1, "submit": t,
                     "duration": rng.randint(60, 7200),
                     "expected_duration": rng.randint(60, 9000),
                     "requested_processors": procs,
                     "requested_memory": rng.choice([128, 256, 512]),
                     "user": rng.randint(1, 30), "status": 1})
    SWFWriter().write(iter(recs), f"{OUT}/workload.swf")


def main():
    make_inputs()
    workload = f"{OUT}/workload.swf"
    sys_cfg = f"{OUT}/sys_config.json"

    allocator = FirstFit()
    dispatcher = FirstInFirstOut(allocator)
    simulator = Simulator(workload, sys_cfg, dispatcher, output_dir=OUT)
    output_file = simulator.start_simulation(system_status=True)

    print("summary:", json.dumps(simulator.summary, indent=1))

    plot_factory = PlotFactory("decision", sys_cfg)
    plot_factory.set_files([output_file], ["FIFO-FF"])
    png = plot_factory.produce_plot("slowdown")
    print("slowdown plot:", png)


if __name__ == "__main__":
    main()
