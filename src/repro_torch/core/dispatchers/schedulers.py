"""Schedulers: FIFO, SJF, LJF, EASY-backfilling, RejectAll (paper §3).

The simple policies (FIFO/SJF/LJF) are *blocking*: they start jobs in
priority order and stop at the first job that cannot be allocated — no
queue-jumping.  EASY-backfilling (EBF, FIFO priority) additionally lets
jobs jump the queue iff they cannot delay the head job's reservation,
computed from walltime *estimates* (the dispatcher never sees true
durations).  RejectAll is the paper's simulator-performance probe (§6.2):
it rejects every submitted job, isolating the simulator core from
dispatching cost.

All policies implement the batched contract: ``plan(ctx)`` turns the
:class:`DispatchContext` into a priority *order* over queue indices and
delegates allocation to ``AllocatorBase.allocate_batch`` (one kernel
launch on the vectorized path, regardless of queue depth).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..job import Job
from .base import SchedulerBase
from .context import DispatchContext, DispatchPlan, ReleaseEvent


class FirstInFirstOut(SchedulerBase):
    name = "FIFO"

    def plan(self, ctx: DispatchContext) -> DispatchPlan:
        return self._greedy_plan(ctx, range(ctx.n_queued), blocking=True)


class ShortestJobFirst(SchedulerBase):
    name = "SJF"

    def plan(self, ctx: DispatchContext) -> DispatchPlan:
        order = sorted(range(ctx.n_queued),
                       key=lambda i: (ctx.est[i], ctx.queued_time[i]))
        return self._greedy_plan(ctx, order, blocking=True)


class LongestJobFirst(SchedulerBase):
    name = "LJF"

    def plan(self, ctx: DispatchContext) -> DispatchPlan:
        order = sorted(range(ctx.n_queued),
                       key=lambda i: (-ctx.est[i], ctx.queued_time[i]))
        return self._greedy_plan(ctx, order, blocking=True)


class RejectAll(SchedulerBase):
    name = "REJECT"

    def __init__(self, allocator=None) -> None:  # allocator unused
        super().__init__(allocator)

    def plan(self, ctx: DispatchContext) -> DispatchPlan:
        return DispatchPlan(rejects=list(ctx.jobs))


class EasyBackfilling(SchedulerBase):
    """EASY backfilling with FIFO priority [Wong & Goscinski '07].

    Per dispatch round:
      1. start queue-head jobs greedily while they fit;
      2. for the first blocked job (the *head*), compute the **shadow
         time** — the earliest instant its request fits given the
         estimated release times of running/just-started jobs — and
         reserve its nodes at that instant;
      3. backfill later queued jobs that fit *now* and either (a) finish
         (by estimate) before the shadow time, or (b) use only resources
         that remain *extra* after the head's reservation.
    """

    name = "EBF"

    def plan(self, ctx: DispatchContext) -> DispatchPlan:
        find = self._make_finder(ctx)
        avail = ctx.avail.copy()
        plan = DispatchPlan()
        j_total = ctx.n_queued

        # --- 1. greedy head dispatch ----------------------------------
        i = 0
        while i < j_total:
            nodes = find(i, avail)
            if nodes is None:
                break
            avail[nodes] -= ctx.req[i][None, :]
            plan.starts.append((ctx.job(i), [int(n) for n in nodes]))
            i += 1
        # telemetry phase counters (DESIGN.md §10); the compiled engine
        # derives the same values post-loop from its carried scalars
        stats = {"dispatch_trips": i + (1 if i < j_total else 0),
                 "shadow_trips": 0, "backfill_admits": 0, "misfit_skips": 0}
        plan.stats["phase_counters"] = stats
        if i >= j_total:
            return plan

        head = i
        plan.skips[ctx.job_id(head)] = "head-blocked"

        # --- 2. shadow time + reservation ------------------------------
        # phase-1 starts are exactly queue indices 0..head-1, in order
        started_idx = [(qi, nodes)
                       for qi, (_, nodes) in enumerate(plan.starts)]
        releases = self._release_events(ctx, started_idx)
        shadow_time, shadow_avail = self._shadow(
            avail, ctx.req[head], int(ctx.n_nodes[head]), releases)
        if shadow_time is None:
            # head never fits even with everything released — should have
            # been rejected at submission; be conservative: no backfilling.
            stats["shadow_trips"] = len(releases)
            stats["misfit_skips"] = j_total - head - 1
            for qi in range(head + 1, j_total):
                plan.skips[ctx.job_id(qi)] = "no-shadow"
            return plan
        # release events consumed by the walk: every tuple at or before
        # the shadow instant (whole tie group applied before the fit test)
        stats["shadow_trips"] = sum(1 for r in releases
                                    if r[0] <= shadow_time)
        head_nodes = find(head, shadow_avail)
        assert head_nodes is not None
        extra = shadow_avail.copy()
        extra[head_nodes] -= ctx.req[head][None, :]

        # --- 3. backfill ------------------------------------------------
        for qi in range(head + 1, j_total):
            est_end = ctx.now + int(ctx.est[qi])
            if est_end <= shadow_time:
                nodes = find(qi, avail)
                if nodes is None:
                    plan.skips[ctx.job_id(qi)] = "no-fit"
                    continue
                avail[nodes] -= ctx.req[qi][None, :]
            else:
                # must not touch the head's reservation: fit within
                # min(available now, extra at shadow)
                combined = np.minimum(avail, extra)
                nodes = find(qi, combined)
                if nodes is None:
                    plan.skips[ctx.job_id(qi)] = "would-delay-head"
                    continue
                avail[nodes] -= ctx.req[qi][None, :]
                extra[nodes] -= ctx.req[qi][None, :]
            plan.starts.append((ctx.job(qi), [int(n) for n in nodes]))
        admits = len(plan.starts) - head
        stats["backfill_admits"] = admits
        stats["misfit_skips"] = (j_total - head - 1) - admits
        return plan

    # ------------------------------------------------------------------
    def _make_finder(self, ctx: DispatchContext) -> Callable:
        """``(queue_index, avail) -> node ids | None`` probe.

        The base finder delegates to the allocator's per-job
        ``find_nodes``; ``VectorizedEasyBackfilling`` overrides this with
        a one-launch batched probe shared by all phases of the round.
        """
        def find(qi: int, avail: np.ndarray) -> Optional[np.ndarray]:
            return self.allocator.find_nodes(
                ctx.req[qi], int(ctx.n_nodes[qi]), avail, ctx.capacity)
        return find

    @staticmethod
    def _release_events(ctx: DispatchContext, started_idx) -> List[Tuple]:
        """(est_release, node_idx, per_node_vec) for running + just-started
        (queue index, nodes) jobs, using walltime estimates only."""
        releases = [ev.as_tuple() for ev in ctx.releases]
        for qi, nodes in started_idx:
            est = ctx.now + int(ctx.est[qi])
            releases.append((est, np.asarray(nodes, dtype=np.int64),
                             ctx.req[qi]))
        releases.sort(key=lambda r: r[0])
        mask = ctx.node_mask
        if mask is not None:
            # ineligible (down/quarantined) nodes must never fit, even at
            # shadow time: drop their release contributions so the scan's
            # cumulative availability stays at the -1 floor there (the
            # fleet engine's shadow walk masks its fit count instead —
            # same decisions, DESIGN.md §9)
            releases = [(t, idx[mask[idx]], vec) for t, idx, vec in releases]
        return releases

    @staticmethod
    def _shadow(avail, head_vec, n_nodes, releases):
        """Earliest estimated time the head fits; availability then.

        Walks the sorted release events, applying all releases sharing a
        timestamp before testing the fit (tie-correct prefix scan).  The
        batched (CUDA) twin of this loop lives in ``kernels/ebf_shadow.py``.
        """
        cur = avail.copy()
        k = 0
        n = len(releases)
        while k < n:
            t = releases[k][0]
            while k < n and releases[k][0] == t:
                _, idx, vec = releases[k]
                cur[idx] += vec[None, :]
                k += 1
            fit = np.all(cur >= head_vec[None, :], axis=1)
            if int(fit.sum()) >= n_nodes:
                return t, cur
        return None, None
