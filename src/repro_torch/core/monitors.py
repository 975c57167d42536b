"""Monitoring tools (paper §3 "Tools"): system status + utilization.

``SystemStatus`` answers point-in-time queries (queued/running/completed,
resource availability, elapsed CPU time).  ``UtilizationMonitor``
accumulates a time series of per-resource utilization — the headless
equivalent of the paper's GUI system-visualization component (snapshots
are rendered by the PlotFactory with the Agg backend).

The monitor is the HOST half of the unified telemetry layer (DESIGN.md
§10): each observed event appends one telemetry-schema sample row
``(t, queue, running, started_cum, requeued_cum, free_<rt>...)``, and
the whole series decodes into a :class:`repro_torch.telemetry.TelemetryTrace`
— the same object the compiled fleet engine's device buffers decode
into.  Stride semantics match the fleet engine exactly: 0-based event
index ``% sample_every == 0`` (the FIRST event is always recorded),
plus a final end-of-sim sample via :meth:`finalize` when the last event
missed the stride.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from ..telemetry import TelemetryTrace
from ..utils import rss_mb


class SystemStatus:
    def __init__(self) -> None:
        self._t0 = time.process_time()

    def query(self, event_manager) -> Dict[str, object]:
        s = event_manager.system_status()
        s["cpu_time_s"] = time.process_time() - self._t0
        s["rss_mb"] = rss_mb()
        return s


def _started_cum(em) -> int:
    """Total start decisions ever executed: every currently-running and
    every completed job was started once, and each failure requeue undid
    one start that was later re-executed (or is pending again)."""
    return em.n_running + em.n_completed + getattr(em, "n_requeued", 0)


class UtilizationMonitor:
    """Accumulates (sim_time, utilization per resource type, queue, running)
    plus telemetry-schema sample rows at an event stride."""

    def __init__(self, sample_every: int = 1) -> None:
        self.sample_every = max(1, sample_every)
        self.times: List[int] = []
        self.util: Dict[str, List[float]] = {}
        self.queued: List[int] = []
        self.running: List[int] = []
        # telemetry-schema rows: (t, queue, running, started_cum,
        # requeued_cum, {rt: free units}) — the free map (not a fixed
        # vector) so resource types appearing mid-run stay decodable
        self._rows: List[Tuple[int, int, int, int, int, Dict[str, int]]] = []
        self._n = 0                 # events observed
        self._last_sampled = -1     # 0-based index of the last sampled event

    # ------------------------------------------------------------------
    def observe(self, event_manager) -> None:
        idx = self._n
        self._n += 1
        if idx % self.sample_every:
            return
        self._record(event_manager, idx)

    def finalize(self, event_manager) -> None:
        """Record the end-of-sim sample if the last event missed the
        stride (call once, after the event loop — and after any livelock
        rejections, so the final queue depth matches the fleet engine)."""
        if self._n and self._last_sampled != self._n - 1:
            self._record(event_manager, self._n - 1)

    def _record(self, em, idx: int) -> None:
        self._last_sampled = idx
        t = int(em.current_time)
        self.times.append(t)
        for rt, u in em.rm.utilization().items():
            self.util.setdefault(rt, []).append(u)
        self.queued.append(em.n_queued)
        self.running.append(em.n_running)
        free = em.rm.available.sum(axis=0)
        self._rows.append((
            t, em.n_queued, em.n_running, _started_cum(em),
            int(getattr(em, "n_requeued", 0)),
            {rt: int(free[i]) for i, rt in enumerate(em.rm.resource_types)},
        ))

    # ------------------------------------------------------------------
    def as_dict(self) -> Dict[str, object]:
        n = len(self.times)
        # a resource type first observed mid-run has a shorter series:
        # front-pad with 0.0 so every series aligns with ``times``
        util = {rt: ([0.0] * (n - len(vs)) + vs) if len(vs) < n else vs
                for rt, vs in self.util.items()}
        return {
            "times": self.times,
            "utilization": util,
            "queued": self.queued,
            "running": self.running,
        }

    def to_trace(
        self,
        name: str,
        resource_types,
        capacity: Dict[str, int],
        phase_counters: Optional[Dict[str, int]] = None,
    ) -> TelemetryTrace:
        """Decode the accumulated rows into the engine-neutral trace."""
        import numpy as np

        rts = tuple(resource_types)
        samples = np.zeros((len(self._rows), 5 + len(rts)), dtype=np.int64)
        for i, (t, q, r, sc, rc, free) in enumerate(self._rows):
            samples[i, :5] = (t, q, r, sc, rc)
            for j, rt in enumerate(rts):
                samples[i, 5 + j] = free.get(rt, 0)
        return TelemetryTrace(
            engine="host", name=name, stride=self.sample_every,
            resource_types=rts, samples=samples,
            phase_counters=phase_counters or {},
            capacity={k: int(v) for k, v in capacity.items()})
