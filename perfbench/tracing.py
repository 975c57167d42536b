"""Spans, CUDA events and the device trace of a traced run.

The benchmark's own spans sit around its calls into the program's
layers (``Tracer.span``); each is also a ``record_function`` range, so
that the profiler's trace places it on the same clock as the device's
operations.  Kernel launches are timed with CUDA events on the current
stream (``Tracer.kernel``).  ``device_activity`` reduces the
profiler's trace of the window to the device's busy time, its idle
gaps (named by the span the host was in) and its operations by time.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "perfbench.window"


class Tracer:
    """Host spans and CUDA-event kernel times, kept in memory."""

    def __init__(self, cuda: bool) -> None:
        self.cuda = cuda
        self.spans: Dict[str, float] = defaultdict(float)
        self._events: List[Tuple[str, object, object]] = []

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """Time the block on the host clock; with ``sync`` the span ends
        when the device has finished what the block enqueued."""
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync and self.cuda:
                    torch.cuda.synchronize()
                self.spans[name] += time.perf_counter() - t0

    @contextlib.contextmanager
    def kernel(self, name: str):
        """Time the launches of the block with CUDA events on the current
        stream; the block ends once they have run."""
        if not self.cuda:
            with self.span(name):
                yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            end.synchronize()
            self._events.append((name, start, end))

    def kernel_ms(self) -> Dict[str, List[float]]:
        """Milliseconds of each timed block, by name (CUDA only)."""
        out: Dict[str, List[float]] = defaultdict(list)
        for name, start, end in self._events:
            out[name].append(start.elapsed_time(end))
        return dict(out)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def device_activity(prof, span_names, top: int = 10) -> Optional[Dict]:
    """The device's activity in the traced window, from the profiler.

    Returns None when the trace holds no window span.  Otherwise
    ``window_s``, ``busy_s`` (the union of the device's operations,
    kernels and copies, inside the window), ``ops`` (``{name: device
    seconds}``), ``device_ops`` (the ``top`` operations by device time)
    and ``idle_gaps`` (the device's idle time by what the host was doing:
    each gap goes to the span of ``span_names`` that covers most of it,
    or to ``"host: other"``).  Times
    in seconds."""
    events = list(prof.events())
    cpu = torch.autograd.DeviceType.CPU
    windows = [e for e in events if e.name == WINDOW
               and e.device_type == cpu]
    if not windows:
        return None
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    # the device's operations: kernels, copies and sets, not the
    # profiler's copies of the host's annotations on the device timeline
    marks = set(span_names) | {WINDOW}
    dev = [e for e in events if e.device_type != cpu
           and not getattr(e, "is_user_annotation", False)
           and e.name not in marks
           and e.time_range.end > w0 and e.time_range.start < w1]
    ops: Dict[str, float] = defaultdict(float)
    for e in dev:
        ops[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    busy = _union([(max(e.time_range.start, w0), min(e.time_range.end, w1))
                   for e in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == cpu
                   and e.name in span_names)
    idle: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    j = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        cover: Dict[str, float] = defaultdict(float)
        k = j
        while k < len(spans) and spans[k][0] < b:
            o = min(b, spans[k][1]) - max(a, spans[k][0])
            if o > 0:
                cover[spans[k][2]] += o
            k += 1
        idle[max(cover, key=cover.get) if cover else "host: other"] += \
            (b - a) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_s,
        "ops": dict(ops),
        "device_ops": _top(ops, top),
        "idle_gaps": _top(idle, top),
    }


def _top(totals: Dict[str, float], n: int) -> List[List]:
    return sorted(([k, v] for k, v in totals.items()),
                  key=lambda kv: -kv[1])[:n]
