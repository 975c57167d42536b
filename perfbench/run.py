#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card, and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> \\
        --seconds <window> --trace <0|1>

From the root of a checkout that holds the port (``src/repro_torch``)
and ``BENCHMARK.json``.  Set-up (process start to the first timed
request: kernel library, inputs from the seed, a warm request) is
``setup_s``; then the cell's entry sends whole requests until
``--seconds`` have passed.  ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` runs the window again under the benchmark's
spans, CUDA events and ``torch.profiler`` and reports its per-layer
metrics.  After the window the output is checked against the plain
reference.

Earlier lines of standard output (``perfbench: {...}``) give the card,
its power limit, the requests and counts of the run; the last line is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``
(each number compared, with its limit), which the last lines of
standard error repeat.  Without a card, with fewer cards than the cell
asks for, without the port beside it, or with JAX or the JAX package
loaded, it exits non-zero and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _card_line():
    """``nvidia-smi``'s name and power limit of each card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()


def _log(obj) -> None:
    print("perfbench: " + json.dumps(obj), flush=True)


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, entry_args=None, entry_hook=None):
    """One run of ``cell``; returns ``(result dict, forbidden modules)``.

    ``device`` is ``"cuda"`` on the chip; the tests pass ``"cpu"`` (the
    port's plain version) with ``entry_args`` ``{"jobs", "seeds"}`` for
    a small grid, and ``entry_hook(entry)`` to break the timed path."""
    import torch

    from perfbench import harness, tracing

    cuda = device == "cuda"
    ent = cell.entry().Entry(cell, seed, device, **(entry_args or {}))
    if cuda:
        _log({"card": _card_line(), "torch": torch.__version__,
              "cuda": torch.version.cuda})
    _log({"setup": ent.setup()})
    if entry_hook is not None:
        entry_hook(ent)
    tracer = tracing.Tracer(cuda) if trace else None
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    if cuda:
        torch.cuda.synchronize()
    ent.reset_counters()
    setup_s = time.perf_counter() - t_start

    requests = work = 0
    window = ent.instrument(tracer) if trace else contextlib.nullcontext()
    mark = torch.profiler.record_function(tracing.WINDOW) if trace \
        else contextlib.nullcontext()
    with window, mark:
        w0 = time.perf_counter()
        deadline = w0 + seconds
        while True:
            work += ent.request(tracer)
            requests += 1
            if time.perf_counter() >= deadline:
                break
        if cuda:
            torch.cuda.synchronize()
        w1 = time.perf_counter()
    activity = None
    if prof is not None:
        prof.__exit__(None, None, None)
        activity = tracing.device_activity(prof, set(tracer.spans))
        prof = None
    counters = ent.device_counters()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ent.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    record = harness.RunRecord(setup_s=setup_s, window_s=w1 - w0,
                               requests=requests, work=work)
    breakdown = None
    if trace:
        record.spans = dict(tracer.spans)
        record.kernels = tracer.kernel_ms()
        record.device, breakdown = _device_time(ent, record, activity)
    compared, failed = ent.check()
    _log({"window": {"requests": requests, "work": work,
                     "window_s": record.window_s,
                     "device_launches": counters,
                     "device_launches_per_request":
                         {k: v / requests for k, v in counters.items()}},
          "check": ent.info})
    metrics = harness.read_metrics(
        cell, record, cell.per_layer if trace else cell.end_to_end)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = record.device["busy_s"]
        dev["window_s"] = record.device["window_s"]
    result = {"correct": all(v <= lim for _, v, lim in compared),
              "attempted": requests, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {n: {"value": v, "limit": lim}
                          for n, v, lim in compared}
    return result, harness.forbidden_modules()


def _device_time(ent, record, activity):
    """``(device record, breakdown)`` of a traced run: the profiler's
    trace where its time of the entry's kernels agrees with the CUDA
    events' (within 10 %), else the CUDA events' intervals alone."""
    events_s = sum(sum(v) for v in record.kernels.values()) * 1e-3
    prof_s = None
    if activity is not None:
        prof_s = sum(t for name, t in activity["ops"].items()
                     if any(k in name for k in ent.KERNELS))
    agree = prof_s is not None and events_s > 0 and \
        abs(prof_s - events_s) <= 0.1 * events_s
    _log({"device_time_check": {"profiler_kernel_s": prof_s,
                                "cuda_events_kernel_s": events_s,
                                "source": "profiler" if agree
                                else "cuda_events"}})
    if agree:
        return ({"busy_s": activity["busy_s"],
                 "window_s": activity["window_s"], "source": "profiler"},
                {"device_ops": activity["device_ops"],
                 "idle_gaps": activity["idle_gaps"]})
    window_s = record.window_s
    idle = {k: v for k, v in record.spans.items() if k in ent.HOST_SPANS}
    idle["host: other"] = max(window_s - events_s - sum(idle.values()), 0.0)
    ops = [[k, sum(v) * 1e-3] for k, v in record.kernels.items()]
    return ({"busy_s": events_s, "window_s": window_s,
             "source": "cuda_events"},
            {"device_ops": sorted(ops, key=lambda kv: -kv[1])[:10],
             "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                 key=lambda kv: -kv[1])[:10]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"perfbench: no program at {src / 'repro_torch'}",
              file=sys.stderr)
        return 2
    # build and kernel caches at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    for p in (str(src), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from perfbench import harness

    cell = harness.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {n}; no run on the CPU", file=sys.stderr)
        return 3
    result, forbidden = run(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda", T_START)
    if forbidden:
        print(f"perfbench: the run loaded {', '.join(forbidden)}; no "
              f"result", file=sys.stderr)
        return 4
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
