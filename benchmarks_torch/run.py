"""Benchmark orchestrator — one module per paper table/figure.

    PYTHONPATH=src python -m benchmarks_torch.run [--only table1,table2,...]
    PYTHONPATH=src python -m benchmarks_torch.run --quick     # dispatch only

Prints ``name,us_per_call,derived`` CSV lines (emit contract) and writes
JSON + plots under results/bench/.  BENCH_SCALE scales workload sizes
(1.0 default ~ minutes; 11 reproduces paper-scale MetaCentrum).

``--quick`` runs a small queue×node sweep of the batched-dispatch
benchmark only and writes ``BENCH_torch_dispatch.json`` at the repo root
(events/s, kernel launches/event, dispatch_time_s) — the perf-trajectory
seed for the DispatchContext/DispatchPlan path.

``--device`` is where the kernels and the fleet run: by default the card
(a mode that needs it raises without one); ``--device cpu`` runs their
plain PyTorch versions.  ``table1``, ``core`` and ``fig_generator`` are
host only; ``roofline`` reads the dry-run records
(``python -m repro_torch.launch.dryrun``) and runs nothing on a device.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

MODULES = ["table1", "table2", "fig_generator", "kernels", "dispatch",
           "core", "roofline", "fleet"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="all")
    ap.add_argument("--out", default="results/bench")
    ap.add_argument("--device", default=None,
                    help="where kernels and the fleet run (default: the "
                         "card; 'cpu' runs their plain versions)")
    ap.add_argument("--quick", action="store_true",
                    help="small dispatch-only sweep -> "
                         "BENCH_torch_dispatch.json "
                         "(with --core: 10k-job sweep only)")
    ap.add_argument("--core", action="store_true",
                    help="simulation-core sweep (10k/100k/1M synthetic "
                         "jobs) -> BENCH_torch_core.json")
    ap.add_argument("--fleet", action="store_true",
                    help="batched fleet grid vs serial host baseline "
                         "-> BENCH_torch_fleet.json (with --quick: CI smoke)")
    ap.add_argument("--failures", action="store_true",
                    help="failure-aware simulation: host scale cell + "
                         "host-vs-fleet crosscheck -> "
                         "BENCH_torch_failures.json "
                         "(with --quick: CI smoke)")
    ap.add_argument("--profile", action="store_true",
                    help="telemetry overhead + per-phase trip profile of "
                         "the fleet grid -> BENCH_torch_profile.json + "
                         "profile_report.txt (fails on >15% events/s "
                         "regression; with --quick: CI smoke)")
    args = ap.parse_args()
    if args.profile:
        from . import bench_profile
        print("name,us_per_call,derived")
        result = bench_profile.run(args.out, quick=args.quick,
                                   device=args.device)
        print(f"# profile {result['n_sims']} sims: telemetry overhead "
              f"{result['overhead_fraction']:.1%} "
              f"(budget {result['max_overhead_fraction']:.0%})",
              file=sys.stderr)
        return
    if args.failures:
        from . import bench_failures
        print("name,us_per_call,derived")
        result = bench_failures.run(args.out, quick=args.quick,
                                    device=args.device)
        cell = result["scale_cell"]
        print(f"# failures scale cell {cell['jobs']} jobs: "
              f"{cell['events_per_s']} events/s, "
              f"requeued={cell['failures']['requeued_jobs']}",
              file=sys.stderr)
        return
    if args.fleet:
        from . import bench_fleet
        print("name,us_per_call,derived")
        result = bench_fleet.run(args.out, quick=args.quick,
                                 device=args.device)
        print(f"# fleet {result['n_sims']} sims: "
              f"{result['speedup_aggregate_events_per_s']}x aggregate "
              f"events/s vs serial host", file=sys.stderr)
        return
    if args.core:
        from . import bench_core
        print("name,us_per_call,derived")
        result = bench_core.run(args.out, quick=args.quick)
        speed = result.get("speedup_vs_baseline", {})
        print(f"# core sweep {result['sizes']}: "
              f"headline={result.get('headline_cell')} "
              f"speedup_vs_baseline={speed}", file=sys.stderr)
        return
    if args.quick:
        from . import bench_dispatch
        print("name,us_per_call,derived")
        result = bench_dispatch.run(args.out, quick=True, device=args.device)
        print(f"# dispatch quick: {result['speedup_batched_vs_per_job']}x "
              f"batched vs per-job on {result['headline']}", file=sys.stderr)
        return
    chosen = MODULES if args.only == "all" else args.only.split(",")

    print("name,us_per_call,derived")
    failures = []
    for name in chosen:
        t0 = time.time()
        try:
            if name == "table1":
                from . import table1_scalability
                table1_scalability.run(args.out)
            elif name == "table2":
                from . import table2_dispatchers
                table2_dispatchers.run(args.out, device=args.device)
            elif name == "fig_generator":
                from . import fig_generator
                fig_generator.run(args.out)
            elif name == "kernels":
                from . import bench_kernels
                bench_kernels.run(args.out, device=args.device)
            elif name == "dispatch":
                from . import bench_dispatch
                bench_dispatch.run(args.out, device=args.device)
            elif name == "core":
                from . import bench_core
                bench_core.run(args.out)
            elif name == "roofline":
                from . import roofline
                roofline.run(args.out)
            elif name == "fleet":
                from . import bench_fleet
                bench_fleet.run(args.out, device=args.device)
            else:
                raise KeyError(name)
            print(f"# {name} done in {time.time()-t0:.1f}s", file=sys.stderr)
        except Exception as e:
            failures.append(name)
            print(f"# {name} FAILED: {e}", file=sys.stderr)
            traceback.print_exc()
    if failures:
        sys.exit(f"benchmark failures: {failures}")


if __name__ == "__main__":
    main()
