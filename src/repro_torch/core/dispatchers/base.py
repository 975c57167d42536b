"""Abstract dispatcher interfaces (paper Fig. 3: SchedulerBase / AllocatorBase).

A *dispatcher* = scheduler ∘ allocator.  The scheduler decides WHICH queued
jobs run next; the allocator decides WHERE (which nodes).  Both are
customizable by subclassing — the paper's extension mechanism.

Batched protocol (DESIGN.md §1): the Simulator builds one frozen
:class:`~.context.DispatchContext` per event point and calls
``SchedulerBase.plan(ctx) -> DispatchPlan``.  Schedulers express policy as
an *order* over queue indices and hand the whole batch to
``AllocatorBase.allocate_batch``, whose vectorized override scores every
(job, node) pair in a single kernel launch.  The legacy per-job entry
points (``schedule`` / ``find_nodes`` / ``allocate``) remain as thin
compatibility shims so existing subclasses keep working.
"""
from __future__ import annotations

import abc
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..job import Job
from ..resources import ResourceManager
from .context import DispatchContext, DispatchPlan, LazySkips

# Legacy dispatching decision: (job, node ids) pairs ready to start now,
# plus optionally jobs to reject.  New code uses DispatchPlan instead.
Decision = Tuple[List[Tuple[Job, List[int]]], List[Job]]

_SCHEDULE_DEPRECATION = (
    "SchedulerBase.schedule(now, queue, event_manager) is deprecated; "
    "override/call plan(ctx: DispatchContext) -> DispatchPlan instead "
    "(DESIGN.md §3 migration guide)."
)


class AllocatorBase(abc.ABC):
    """Chooses nodes for jobs against a scratch availability matrix."""

    name: str = "abstract"

    @abc.abstractmethod
    def find_nodes(
        self,
        request_vec: np.ndarray,
        n_nodes: int,
        avail: np.ndarray,
        capacity: np.ndarray,
    ) -> Optional[np.ndarray]:
        """Return ``n_nodes`` node indices whose availability covers
        ``request_vec``, or None if impossible.  MUST NOT modify ``avail``."""

    # -- batched entry point (the new contract) ------------------------
    def allocate_batch(
        self,
        ctx: DispatchContext,
        order: Sequence[int],
        avail: Optional[np.ndarray] = None,
        blocking: bool = True,
    ) -> List[Tuple[int, Optional[List[int]]]]:
        """Allocate the queued jobs named by ``order`` (queue indices,
        scheduler priority order) against ``avail`` (defaults to a copy of
        ``ctx.avail``; modified in place so later jobs see reduced
        availability).

        Returns ``(queue_index, node ids | None)`` pairs in processing
        order.  With ``blocking=True`` (the paper's non-queue-jumping
        policies) processing stops at the first job that cannot be
        allocated; the failure itself is recorded.

        This default preserves the sequential per-job semantics (one
        ``find_nodes`` probe per job); ``VectorizedAllocator`` overrides
        it with a single batched kernel launch + host-side greedy commit.
        """
        if avail is None:
            avail = ctx.avail.copy()
        out: List[Tuple[int, Optional[List[int]]]] = []
        for qi in order:
            vec = ctx.req[qi]
            nodes = self.find_nodes(vec, int(ctx.n_nodes[qi]), avail,
                                    ctx.capacity)
            if nodes is None:
                out.append((int(qi), None))
                if blocking:
                    break
            else:
                avail[nodes] -= vec[None, :]
                out.append((int(qi), [int(n) for n in nodes]))
        return out

    # -- legacy per-job loop (kept for old-style callers) ---------------
    def allocate(
        self,
        jobs: Sequence[Job],
        avail: np.ndarray,
        rm: ResourceManager,
        stop_at_first_failure: bool = False,
    ) -> List[Tuple[Job, Optional[List[int]]]]:
        """Sequentially allocate ``jobs`` against ``avail`` (modified in
        place for successful allocations so later jobs see reduced
        availability)."""
        out: List[Tuple[Job, Optional[List[int]]]] = []
        for job in jobs:
            vec = rm.request_vector(job)
            nodes = self.find_nodes(vec, job.requested_nodes, avail, rm.capacity)
            if nodes is None:
                out.append((job, None))
                if stop_at_first_failure:
                    break
            else:
                avail[nodes] -= vec[None, :]
                out.append((job, [int(n) for n in nodes]))
        return out

    def reset(self) -> None:
        """Clear any per-run state (no-op for stateless allocators)."""


class SchedulerBase(abc.ABC):
    """Produces the dispatching plan for one event point.

    Subclasses implement :meth:`plan`.  Pre-batched subclasses that only
    override the legacy :meth:`schedule` keep working: the default
    ``plan`` detects the override and bridges through it (with a
    ``DeprecationWarning``).
    """

    name: str = "abstract"

    def __init__(self, allocator: Optional[AllocatorBase]) -> None:
        self.allocator = allocator

    @property
    def dispatcher_name(self) -> str:
        if self.allocator is None:
            return self.name
        return f"{self.name}-{self.allocator.name}"

    # -- new contract ---------------------------------------------------
    def plan(self, ctx: DispatchContext) -> DispatchPlan:
        """Return the :class:`DispatchPlan` for this event point.

        ``ctx`` is the *dispatcher-visible* system status: queued-job
        request matrix, availability/capacity, and **estimated** release
        events — never true durations.
        """
        if type(self).schedule is not SchedulerBase.schedule:
            # legacy subclass: bridge through its schedule() override.
            # Legacy code reads availability from the live resource
            # manager, so a wrapper's context rewrite (e.g.
            # FaultAwareScheduler masking quarantined nodes out of
            # ctx.avail) must be projected onto it for the duration of
            # the call.  Estimate rewrites (ctx.est) cannot be bridged —
            # they exist only in the context.
            warnings.warn(_SCHEDULE_DEPRECATION, DeprecationWarning,
                          stacklevel=2)
            rm = getattr(ctx.event_manager, "rm", None)
            rewritten = rm is not None and \
                not np.array_equal(rm.available, ctx.avail)
            if rewritten:
                saved = rm.available
                rm.available = ctx.avail.copy()
            try:
                to_start, to_reject = self.schedule(
                    ctx.now, list(ctx.jobs), ctx.event_manager)
            finally:
                if rewritten:
                    rm.available = saved
            return DispatchPlan(starts=list(to_start),
                                rejects=list(to_reject))
        raise NotImplementedError(
            f"{type(self).__name__} must override plan() (or the legacy "
            f"schedule())")

    # -- legacy contract (compatibility shim) ---------------------------
    def schedule(self, now: int, queue: Sequence[Job], event_manager) -> Decision:
        """Deprecated per-job entry point; builds a context and delegates
        to :meth:`plan`, returning the bare ``(to_start, to_reject)``."""
        warnings.warn(_SCHEDULE_DEPRECATION, DeprecationWarning, stacklevel=2)
        ctx = DispatchContext.from_event_manager(now, event_manager)
        return self.plan(ctx).as_decision()

    def reset(self) -> None:
        """Forget any learned/accumulated state so repeated runs start
        identical (Experiment calls this between repeats)."""
        if self.allocator is not None:
            self.allocator.reset()

    # helper shared by subclasses -------------------------------------
    def _greedy_plan(
        self,
        ctx: DispatchContext,
        order: Sequence[int],
        blocking: bool = True,
    ) -> DispatchPlan:
        """Allocate in ``order`` via the batched allocator entry point."""
        res = self.allocator.allocate_batch(ctx, order, blocking=blocking)
        skips = LazySkips()
        plan = DispatchPlan(skips=skips)
        # telemetry phase counter (DESIGN.md §10): allocation probes this
        # round — starts plus the one blocked probe when a prefix stopped
        # (len(res) includes the recorded failure); matches the compiled
        # engine's greedy-loop trip count exactly
        plan.stats["phase_counters"] = {"dispatch_trips": len(res)}
        for qi, nodes in res:
            if nodes is None:
                skips[ctx.job_id(qi)] = "no-fit"
            else:
                plan.starts.append((ctx.job(qi), nodes))
        # allocate_batch processes a prefix of ``order`` (it stops at the
        # first failure when blocking); everything after is "blocked" —
        # labeled lazily so the hot path stays O(started), not O(queue)
        k = len(res)
        if k < len(order):
            guard = None
            table = ctx.table
            if table is not None and ctx.queue_rows.size:
                # per-row generation snapshot: materializing after any of
                # these rows recycled must fail loudly, not mislabel a
                # successor job (C-speed gather, no per-job Python; the
                # FIFO identity order reduces to a plain slice)
                if isinstance(order, range) and order.start == 0 \
                        and order.step == 1:
                    tail_rows = ctx.queue_rows[k:order.stop]
                else:
                    tail_rows = ctx.queue_rows[
                        np.asarray(order[k:], dtype=np.int64)]
                gen_snap = table.gen[tail_rows].copy()
                guard = lambda: np.array_equal(table.gen[tail_rows],
                                               gen_snap)
            skips.defer(
                lambda: [ctx.job_id(qi) for qi in order[k:]], "blocked",
                guard)
        return plan

    def _greedy(
        self,
        ordered: Sequence[Job],
        event_manager,
        blocking: bool = True,
    ) -> Decision:
        """Legacy helper (job objects, event-manager availability)."""
        rm = event_manager.rm
        avail = rm.available.copy()
        res = self.allocator.allocate(
            ordered, avail, rm, stop_at_first_failure=blocking)
        to_start = [(j, n) for j, n in res if n is not None]
        return to_start, []


class Dispatcher:
    """Convenience bundle (scheduler + allocator) used by the Simulator."""

    def __init__(self, scheduler: SchedulerBase) -> None:
        self.scheduler = scheduler

    @property
    def name(self) -> str:
        return self.scheduler.dispatcher_name

    _counters = None

    def plan(self, ctx: DispatchContext) -> DispatchPlan:
        """Run the scheduler and stamp per-event instrumentation into
        ``plan.stats`` (kernel launches, queue depth)."""
        counters = Dispatcher._counters
        if counters is None:
            from ...kernels import counters
            Dispatcher._counters = counters
        launches0 = counters.launch_count()
        plan = self.scheduler.plan(ctx)
        plan.stats.setdefault("kernel_launches",
                              counters.launch_count() - launches0)
        plan.stats.setdefault("queued", ctx.n_queued)
        return plan

    def dispatch(self, now: int, event_manager) -> Decision:
        """Legacy entry point: context built here, plan downgraded to the
        bare decision tuple."""
        ctx = DispatchContext.from_event_manager(now, event_manager)
        return self.plan(ctx).as_decision()
