"""Paper §7 case study — 8 dispatchers (4 schedulers × 2 allocators) on a
Seth-like workload via the experimentation tool (Fig. 5), producing the
comparative plots of Figs. 10-13 (which need matplotlib).

    python examples_torch/dispatcher_comparison.py [n_jobs] [--vectorized]
        [--device DEVICE]

The 8 dispatchers lower onto the fleet engine: one ``FleetRunner.run``
on the card, the ``fleet_engine`` kernel.  Pass ``--vectorized`` to
additionally run the batched DispatchContext/DispatchPlan engines on the
host simulator (one ``alloc_score_batch`` CUDA launch per event) and
report their kernel-launch economy next to the numpy baselines.
``--device`` (default: the card) is where both run; ``--device cpu``
runs the kernels' plain PyTorch versions.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from repro_torch.core.dispatchers import (BestFit, EasyBackfilling, FirstFit,
                                          FirstInFirstOut, LongestJobFirst,
                                          ShortestJobFirst)
from repro_torch.experimentation import Experiment
from benchmarks_torch.common import SETH, seth_jobs


def main():
    argv = sys.argv[1:]
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    args = [a for a in argv if not a.startswith("--")]
    vectorized = "--vectorized" in argv
    n = int(args[0]) if args else 4000
    exp = Experiment("dispatcher_comparison", list(seth_jobs(n, seed=7)),
                     SETH, output_dir="results", device=device)
    exp.gen_dispatchers(
        [FirstInFirstOut, ShortestJobFirst, LongestJobFirst, EasyBackfilling],
        [FirstFit, BestFit])
    if vectorized:
        from repro_torch.core.dispatchers.vectorized import (
            VectorizedAllocator, VectorizedEasyBackfilling)
        exp.add_dispatcher(FirstInFirstOut(
            VectorizedAllocator("FF", device=device)))
        exp.add_dispatcher(FirstInFirstOut(
            VectorizedAllocator("BF", device=device)))
        exp.add_dispatcher(VectorizedEasyBackfilling(
            VectorizedAllocator("FF", device=device)))
    results = exp.run_simulation()
    table = {k: {"cpu_s": round(v["summaries"][0]["cpu_time_s"], 2),
                 "dispatch_s": round(v["summaries"][0]["dispatch_time_s"], 2),
                 "kernel_launches_per_event": round(
                     v["summaries"][0]["kernel_launches_per_event"], 2),
                 "makespan": v["summaries"][0]["sim_end_time"]}
             for k, v in results.items()}
    print(json.dumps(table, indent=1))
    print("plots under results/dispatcher_comparison/")


if __name__ == "__main__":
    main()
