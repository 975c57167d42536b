"""Failure injection + fault-aware dispatching (DESIGN §7).

``FailureInjector`` produces a deterministic fail/repair event trace from
an exponential failure model (MTBF per host) — fed to the core
``NodeFailureModel`` additional-data hook, which re-queues victim jobs
(checkpoint/restart semantics: the re-queued job's remaining duration is
reduced to the last checkpoint boundary).  The trace is precomputed as
arrays from a seeded ``np.random.Generator`` (the repo-wide seeding
convention), so failure scenarios can feed the compiled fleet loop
directly via :meth:`FailureInjector.arrays`.

``FaultAwareScheduler`` wraps any scheduler and avoids placing jobs on
nodes with recent failures (blast-radius avoidance) by masking them from
the allocator's availability view.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core.dispatchers.base import SchedulerBase
from ..core.dispatchers.context import DispatchContext, DispatchPlan
from ..core.job import Job


class FailureInjector:
    """Seeded per-node fail/repair trace, precomputed as arrays.

    Each node alternates exponential up-times (mean ``mtbf_s``) with
    fixed ``repair_s`` outages until ``horizon_s``.  All inter-failure
    draws come from one vectorized ``np.random.Generator`` batch: per
    node, enough exponential gaps are drawn up front that their running
    sum crosses the horizon (over-drawing changes nothing — each gap is
    an independent draw consumed left to right, so determinism only
    depends on the seed and the per-node draw count).
    """

    def __init__(self, n_nodes: int, mtbf_s: float, repair_s: float,
                 horizon_s: int, seed: int = 0) -> None:
        rng = np.random.default_rng(seed)
        times: List[int] = []
        nodes: List[int] = []
        fails: List[bool] = []
        # worst-case draws per node: horizon of back-to-back minimal
        # cycles is unbounded for exponential draws, so draw in chunks
        chunk = max(int(horizon_s / max(mtbf_s, 1e-9)) * 2 + 8, 16)
        for node in range(n_nodes):
            t = 0.0
            gaps = rng.exponential(mtbf_s, size=chunk)
            g = 0
            while True:
                if g == gaps.shape[0]:
                    gaps = rng.exponential(mtbf_s, size=chunk)
                    g = 0
                t += gaps[g]
                g += 1
                if t >= horizon_s:
                    break
                times.append(int(t))
                nodes.append(node)
                fails.append(True)
                t += repair_s
                if t >= horizon_s:
                    break
                times.append(int(t))
                nodes.append(node)
                fails.append(False)
        order = np.lexsort((np.asarray(nodes, dtype=np.int64),
                            np.asarray(times, dtype=np.int64)))
        self.times = np.asarray(times, dtype=np.int64)[order]
        self.nodes = np.asarray(nodes, dtype=np.int64)[order]
        self.is_fail = np.asarray(fails, dtype=bool)[order]

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(times int64[E], nodes int64[E], is_fail bool[E])`` sorted by
        (time, node) — the compiled-loop-ready representation."""
        return self.times, self.nodes, self.is_fail

    @property
    def events(self) -> List[Tuple[int, int, str]]:
        return [(int(t), int(n), "fail" if f else "repair")
                for t, n, f in zip(self.times, self.nodes, self.is_fail)]

    def trace(self) -> List[Tuple[int, int, str]]:
        return self.events


class CheckpointRestartPolicy:
    """Adjusts a re-queued job so it only re-runs work since the last
    checkpoint (period ``ckpt_every_s``) — the simulation counterpart of
    the reference's ``checkpoint`` package (not ported yet).  Called by
    the cluster layer on re-queue."""

    def __init__(self, ckpt_every_s: int = 600) -> None:
        self.ckpt_every_s = ckpt_every_s
        self.recovered_work_s = 0

    def on_requeue(self, job: Job, ran_for_s: int) -> None:
        saved = (ran_for_s // self.ckpt_every_s) * self.ckpt_every_s
        saved = min(saved, max(job.duration - 1, 0))
        job.duration = max(job.duration - saved, 1)
        job.attrs["restarts"] = int(job.attrs.get("restarts", 0)) + 1
        self.recovered_work_s += saved


class FaultAwareScheduler(SchedulerBase):
    """Decorator: masks quarantined nodes out of the availability matrix
    before delegating to the wrapped scheduler."""

    def __init__(self, inner: SchedulerBase,
                 quarantine_s: int = 3600) -> None:
        super().__init__(inner.allocator)
        self.inner = inner
        self.name = f"FA({inner.name})"
        self.quarantine_s = quarantine_s
        self._recent_failures: List[Tuple[int, int]] = []   # (time, node)

    def note_failure(self, t: int, node: int) -> None:
        self._recent_failures.append((t, node))

    def quarantined(self, now: int) -> List[int]:
        self._recent_failures = [(t, n) for t, n in self._recent_failures
                                 if now - t < self.quarantine_s]
        return [n for _, n in self._recent_failures]

    def reset(self) -> None:
        super().reset()
        self.inner.reset()
        self._recent_failures.clear()

    def plan(self, ctx: DispatchContext) -> DispatchPlan:
        bad = self.quarantined(ctx.now)
        if bad:
            # pure context rewrite: quarantined nodes look unusable to the
            # wrapped planner (no mutation of the resource manager).  The
            # -1 floor (not 0) kills even zero-request fits — the same
            # value-based exclusion the core applies for its native
            # failure schedule — and the combined node_mask keeps the EBF
            # release walk from resurrecting these nodes at shadow time.
            masked = ctx.avail.copy()
            masked[bad] = -1
            mask = ctx.node_mask.copy() if ctx.node_mask is not None \
                else np.ones(ctx.avail.shape[0], dtype=bool)
            mask[bad] = False
            ctx = ctx.replace(avail=masked, node_mask=mask)
        return self.inner.plan(ctx)
