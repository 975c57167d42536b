"""Dispatcher-evaluation metrics (paper §7.2).

Reads the simulator's two output streams (per-job records and per-event
bench records, JSONL) and derives:

* job slowdown distribution       slowdown_j = (T_w + T_r) / T_r
* queue-size distribution          (per dispatching time point)
* dispatch CPU time per event      (dispatcher performance)
* dispatch CPU time vs queue size  (scalability, paper Fig. 13)
* makespan / throughput / resource utilization summaries
"""
from __future__ import annotations

import json
from typing import Dict, Iterator, List, Tuple


def _read_jsonl(path: str) -> Iterator[Dict]:
    with open(path, "rb") as fh:
        for line in fh:
            line = line.strip()
            if line:
                yield json.loads(line)


def job_records(output_path: str) -> Iterator[Dict]:
    yield from _read_jsonl(output_path)


def slowdowns(output_path: str) -> List[float]:
    out = []
    for rec in _read_jsonl(output_path):
        if rec.get("slowdown") is not None:
            out.append(float(rec["slowdown"]))
    return out


def waiting_times(output_path: str) -> List[float]:
    return [float(r["waiting"]) for r in _read_jsonl(output_path)
            if r.get("waiting") is not None]


def bench_series(bench_path: str) -> Dict[str, List[float]]:
    t, queue, running, dispatch_s, rss = [], [], [], [], []
    summary = None
    for rec in _read_jsonl(bench_path):
        if "summary" in rec:
            summary = rec["summary"]
            continue
        t.append(rec["t"])
        queue.append(rec["queue"])
        running.append(rec["running"])
        dispatch_s.append(rec["dispatch_s"])
        rss.append(rec["rss_mb"])
    return {"t": t, "queue": queue, "running": running,
            "dispatch_s": dispatch_s, "rss_mb": rss, "summary": summary}


def telemetry_series(telemetry_path: str) -> Dict[str, object]:
    """Decode a ``{name}-telemetry.jsonl`` structured trace (either
    engine) into plottable series: sample columns as lists, per-type
    utilization fractions, plus the header's phase counters."""
    from ..telemetry import TelemetryTrace

    trace = TelemetryTrace.read_jsonl(telemetry_path)
    out: Dict[str, object] = {
        c: trace.column(c).tolist() for c in trace.columns}
    out["utilization"] = {rt: trace.utilization(rt).tolist()
                          for rt in trace.resource_types}
    out["phase_counters"] = dict(trace.phase_counters)
    out["stride"] = trace.stride
    out["engine"] = trace.engine
    out["truncated"] = trace.truncated
    return out


def dispatch_time_by_queue_size(bench_path: str, bucket: int = 10
                                ) -> List[Tuple[int, float, int]]:
    """[(queue_bucket, mean dispatch seconds, count)] — paper Fig. 13."""
    acc: Dict[int, List[float]] = {}
    for rec in _read_jsonl(bench_path):
        if "summary" in rec:
            continue
        b = (rec["queue"] // bucket) * bucket
        acc.setdefault(b, []).append(rec["dispatch_s"])
    return [(b, sum(v) / len(v), len(v)) for b, v in sorted(acc.items())]


def percentiles(values: List[float], qs=(0.25, 0.5, 0.75, 0.95)) -> Dict[str, float]:
    if not values:
        return {f"p{int(q*100)}": 0.0 for q in qs} | {"mean": 0.0, "max": 0.0}
    s = sorted(values)
    out = {}
    for q in qs:
        idx = min(int(q * len(s)), len(s) - 1)
        out[f"p{int(q*100)}"] = s[idx]
    out["mean"] = sum(s) / len(s)
    out["max"] = s[-1]
    return out
