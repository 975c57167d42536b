"""Advanced dispatchers built ON AccaSim — the paper's stated purpose
("develop novel advanced dispatchers by exploiting information regarding
the current system status", §1; data-driven dispatching per [14]).

* :class:`PriorityAging` — FIFO with priority classes and queue-time
  aging (prevents starvation; the classic production scheduler baseline).
* :class:`WalltimeCorrectedEBF` — EASY backfilling whose walltime
  estimates are corrected by an online per-user model of past
  (actual / requested) runtime ratios — the data-driven idea of
  Galleguillos et al. [14] / Gaussier et al. [15]: user estimates are
  systematically inflated, and tighter estimates make backfilling far
  more effective.
* :class:`EnergyCappedScheduler` — wraps any scheduler and defers
  dispatch of jobs that would push the PowerModel's additional-data
  estimate past a configurable cap (the paper's power-aware example).

All three showcase the batched protocol's composability: aging is a sort
over ``ctx`` arrays, walltime correction is a *context rewrite*
(``ctx.replace(est=..., releases=...)`` — no mutation of Job objects),
and the energy cap is a *plan rewrite* (trim another scheduler's plan).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..job import Job
from .base import SchedulerBase
from .context import DispatchContext, DispatchPlan, ReleaseEvent
from .schedulers import EasyBackfilling


class PriorityAging(SchedulerBase):
    """Priority queue with aging: effective priority = base priority
    (job.attrs['priority'], default 0) + age_weight * waiting time."""

    name = "PRIO"

    def __init__(self, allocator, age_weight: float = 1.0 / 3600.0) -> None:
        super().__init__(allocator)
        self.age_weight = age_weight

    def plan(self, ctx: DispatchContext) -> DispatchPlan:
        def key(i: int):
            base = float(ctx.jobs[i].attrs.get("priority", 0))
            age = (ctx.now - int(ctx.queued_time[i])) * self.age_weight
            return -(base + age)
        order = sorted(range(ctx.n_queued), key=key)
        return self._greedy_plan(ctx, order, blocking=True)


class WalltimeCorrectedEBF(EasyBackfilling):
    """EASY backfilling with an online walltime-correction model.

    Tracks the running mean of (actual runtime / requested walltime) per
    user; the dispatcher-visible estimate of a queued job is scaled by
    its user's historical ratio (floored to keep estimates admissible).
    The event manager still uses true durations for completions — only
    the *dispatching decision* sees corrected estimates, mirroring the
    paper's separation.  Correction is a pure context rewrite: queue
    estimates and running-job release times are replaced in a derived
    ``DispatchContext`` before the standard EBF plan runs.
    """

    name = "dEBF"

    def __init__(self, allocator, floor_ratio: float = 0.05,
                 blend: float = 0.8) -> None:
        super().__init__(allocator)
        self.floor_ratio = floor_ratio
        self.blend = blend
        self._sum: Dict[int, float] = defaultdict(float)
        self._cnt: Dict[int, int] = defaultdict(int)

    def reset(self) -> None:
        super().reset()
        self._sum.clear()
        self._cnt.clear()

    # -- online model ---------------------------------------------------
    def observe_completion(self, job: Job) -> None:
        if job.start_time is None or job.end_time is None:
            return
        actual = max(job.end_time - job.start_time, 1)
        req = max(job.expected_duration, 1)
        self._sum[job.user_id] += actual / req
        self._cnt[job.user_id] += 1

    def corrected(self, job: Job) -> int:
        if not self._cnt[job.user_id]:
            return max(job.expected_duration, 1)
        ratio = self._sum[job.user_id] / self._cnt[job.user_id]
        ratio = self.blend * ratio + (1 - self.blend) * 1.0
        ratio = min(max(ratio, self.floor_ratio), 1.0)
        return max(int(job.expected_duration * ratio), 1)

    # -- plug corrected estimates into the EBF machinery -----------------
    def plan(self, ctx: DispatchContext) -> DispatchPlan:
        est = np.array([self.corrected(j) for j in ctx.jobs],
                       dtype=np.int64).reshape(ctx.est.shape)
        releases = []
        for ev in ctx.releases:
            job = ev.job
            t = max(job.start_time + self.corrected(job), ctx.now + 1)
            releases.append(ReleaseEvent(time=int(t), nodes=ev.nodes,
                                         vec=ev.vec, job=job))
        releases.sort(key=lambda ev: ev.time)
        return super().plan(ctx.replace(est=est, releases=tuple(releases)))


class EnergyCappedScheduler(SchedulerBase):
    """Defers dispatches that would exceed a system power cap.

    Consumes the PowerModel additional-data view: estimates each
    candidate job's marginal power as Σ(request · watts) and trims the
    inner scheduler's plan so projected power stays under ``cap_watts``
    (paper's power-aware dispatching example, refs [5, 6, 37])."""

    name = "ECAP"

    def __init__(self, inner: SchedulerBase, watts_per_unit: Dict[str, float],
                 cap_watts: float, idle_node_watts: float = 50.0) -> None:
        super().__init__(inner.allocator)
        self.inner = inner
        self.name = f"ECAP({inner.name})"
        self.watts = watts_per_unit
        self.cap = cap_watts
        self.idle = idle_node_watts
        self.deferred = 0

    def reset(self) -> None:
        super().reset()
        self.inner.reset()
        self.deferred = 0

    def _power_now(self, ctx: DispatchContext) -> float:
        used = (ctx.capacity - ctx.avail).sum(axis=0)
        p = self.idle * ctx.capacity.shape[0]
        for i, rt in enumerate(ctx.resource_types):
            p += self.watts.get(rt, 0.0) * float(used[i])
        return p

    def _job_power(self, job: Job) -> float:
        return sum(self.watts.get(rt, 0.0) * q * job.requested_nodes
                   for rt, q in job.requested_resources.items())

    def plan(self, ctx: DispatchContext) -> DispatchPlan:
        plan = self.inner.plan(ctx)
        budget = self.cap - self._power_now(ctx)
        kept = []
        for job, nodes in plan.starts:
            need = self._job_power(job)
            if need <= budget:
                kept.append((job, nodes))
                budget -= need
            else:
                self.deferred += 1
                plan.skips[job.id] = "power-cap"
        plan.starts = kept
        return plan
