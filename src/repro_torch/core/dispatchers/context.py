"""Batched dispatch protocol: ``DispatchContext`` in, ``DispatchPlan`` out.

The simulator↔dispatcher contract (DESIGN.md §1).  Instead of the legacy
per-job callback (``SchedulerBase.schedule(now, queue, event_manager)``
pulling one job at a time through ``AllocatorBase.find_nodes``), the
Simulator builds ONE frozen :class:`DispatchContext` per event point — the
whole queue as a dense request matrix ``[J, R]`` next to the availability
matrix ``[N, R]`` — and the dispatcher answers with a
:class:`DispatchPlan`.  This is what lets the vectorized path score every
(job, node) pair in a single ``alloc_score_batch`` kernel launch instead
of O(queue) per-job launches.

Array-native core (DESIGN.md §4): the context's arrays are *slices of
the JobTable columns* — ``from_event_manager`` is a handful of numpy
gather ops, never a Python loop over ``Job`` objects.  The two
object-shaped views (``jobs`` façade tuple, ``releases`` event tuple)
are built lazily on first access from row snapshots taken at
construction, so policies that never touch them (FIFO/SJF/LJF) pay
nothing for them.

Dispatchers become pure functions of the context: trivially testable
(build a context by hand, inspect the plan) and composable (wrap a plan,
rewrite a context).
"""
from __future__ import annotations

import dataclasses
from collections.abc import MutableMapping
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..job import Job

_EMPTY_ROWS = np.zeros(0, dtype=np.int64)


@dataclass(frozen=True)
class ReleaseEvent:
    """Dispatcher-visible estimated release of a running job's resources.

    ``time`` uses walltime *estimates* (never true durations); ``nodes``
    and ``vec`` describe what comes back when the job releases.  The
    ``job`` handle is kept so data-driven dispatchers can re-estimate the
    release time (e.g. walltime correction) without touching the manager.
    """

    time: int
    nodes: np.ndarray            # int64[K]  node indices
    vec: np.ndarray              # int64[R]  per-node request vector
    job: Job

    def as_tuple(self) -> Tuple[int, np.ndarray, np.ndarray]:
        return self.time, self.nodes, self.vec


@dataclass(frozen=True)
class DispatchContext:
    """Frozen snapshot of everything a dispatcher may look at (paper §3:
    the dispatcher-visible system status) for one event point.

    Array fields are dense and batched — jobs on axis 0, resource types
    on the trailing axis — so they feed the batched kernels directly.
    Planners must treat every array as read-only (copy before scratching).
    """

    now: int
    req: np.ndarray                       # int64[J, R] per-node request matrix
    n_nodes: np.ndarray                   # int64[J]    requested node counts
    est: np.ndarray                       # int64[J]    walltime estimates (>= 1)
    queued_time: np.ndarray               # int64[J]    queue-entry times
    avail: np.ndarray                     # int64[N, R] current availability
    capacity: np.ndarray                  # int64[N, R] node capacities
    resource_types: Tuple[str, ...] = ()
    # bool[N] dispatch-eligibility mask, or None when every node is
    # eligible.  Ineligible nodes (down / quarantined after a failure —
    # DESIGN.md §9) additionally have their ``avail`` row floored to -1,
    # so every value-based fit test (``avail >= req``, including
    # zero-request columns) excludes them without any allocator changes;
    # the mask itself exists for consumers that reason about *future*
    # availability (the EBF release walk filters released nodes by it).
    node_mask: Optional[np.ndarray] = None
    event_manager: object = field(default=None, repr=False, compare=False)
    # queued rows in the job table (FIFO order); empty when built by hand
    queue_rows: np.ndarray = field(default_factory=lambda: _EMPTY_ROWS,
                                   repr=False, compare=False)
    table: object = field(default=None, repr=False, compare=False)
    # lazy object views — pass the public names `jobs=` / `releases=` to
    # `replace()` (the dataclass constructor takes `_jobs=` / `_releases=`);
    # None means "materialize from the table on first access"
    _jobs: Optional[Tuple[Job, ...]] = field(default=None, repr=False,
                                             compare=False)
    _releases: Optional[Tuple[ReleaseEvent, ...]] = field(
        default=None, repr=False, compare=False)

    # ------------------------------------------------------------------
    @property
    def jobs(self) -> Tuple[Job, ...]:
        """Queued jobs as row-view façades, FIFO arrival order (lazy)."""
        if self._jobs is None:
            if self.table is None:
                if self.queue_rows.size:
                    raise ValueError(
                        "hand-built DispatchContext has queue rows but no "
                        "table; pass _jobs= (or use replace(jobs=...))")
                object.__setattr__(self, "_jobs", ())
                return self._jobs
            view = self.table.view
            object.__setattr__(
                self, "_jobs", tuple(view(int(r)) for r in self.queue_rows))
        return self._jobs

    @property
    def releases(self) -> Tuple[ReleaseEvent, ...]:
        """Running jobs' estimated releases, sorted by time.

        Materialized lazily from the event manager's running set, so
        policies that ignore releases (FIFO/SJF/LJF) pay nothing.  Read
        it during planning (before the plan's starts commit) — that is
        when the snapshot semantics of the old eager field held."""
        if self._releases is None:
            table = self.table
            events = []
            if table is not None and self.event_manager is not None:
                rows, times = self.event_manager.release_times()
                if rows.size:
                    order = np.argsort(times, kind="stable")
                    for k in order:
                        row = int(rows[k])
                        # copies, not views: rows recycle and schedulers
                        # may scratch on these arrays (same aliasing rule
                        # as ResourceManager.request_vector)
                        events.append(ReleaseEvent(
                            time=int(times[k]),
                            nodes=table.assigned(row).copy(),
                            vec=table.req[row].copy(),
                            job=table.view(row)))
            object.__setattr__(self, "_releases", tuple(events))
        return self._releases

    def job(self, qi: int) -> Job:
        """Façade for queue index ``qi`` without materializing the whole
        ``jobs`` tuple (hot-path helper for planners)."""
        if self._jobs is not None:
            return self._jobs[qi]
        return self.table.view(int(self.queue_rows[qi]))

    def job_id(self, qi: int) -> str:
        """Id of queue index ``qi`` without materializing any façade."""
        if self._jobs is None and self.table is not None \
                and self.queue_rows.size:
            return self.table.ids[int(self.queue_rows[qi])]
        return self.jobs[qi].id

    @property
    def n_queued(self) -> int:
        return int(self.req.shape[0])

    @property
    def n_system_nodes(self) -> int:
        return int(self.avail.shape[0])

    def replace(self, **changes) -> "DispatchContext":
        """Functional update (the context itself is frozen).  Accepts the
        public names ``jobs`` and ``releases`` for the lazy views."""
        if "jobs" in changes:
            changes["_jobs"] = tuple(changes.pop("jobs"))
        if "releases" in changes:
            changes["_releases"] = tuple(changes.pop("releases"))
        return dataclasses.replace(self, **changes)

    def release_tuples(self) -> List[Tuple[int, np.ndarray, np.ndarray]]:
        return [ev.as_tuple() for ev in self.releases]

    # ------------------------------------------------------------------
    @classmethod
    def from_event_manager(cls, now: int, event_manager) -> "DispatchContext":
        """Build the per-event snapshot the Simulator hands to planners —
        O(1) numpy gathers over the job table, no per-job Python work."""
        rm = event_manager.rm
        table = event_manager.table
        rows = event_manager.queue_rows()
        req = table.req[rows]
        n_nodes = table.requested_nodes[rows]
        est = np.maximum(table.expected_duration[rows], 1)
        queued = table.queued_time[rows]     # always set once QUEUED
        avail = rm.available.copy()
        mask = None
        eligibility = getattr(event_manager, "node_eligibility", None)
        if eligibility is not None:
            mask = eligibility(int(now))
            if mask is not None and mask.all():
                mask = None                  # no failures in effect
            if mask is not None:
                avail[~mask] = -1            # value-floor: never fits
        return cls(
            now=int(now), req=req, n_nodes=n_nodes,
            est=est, queued_time=queued, avail=avail,
            capacity=rm.capacity,
            resource_types=tuple(rm.resource_types), node_mask=mask,
            event_manager=event_manager, queue_rows=rows, table=table)


def context_from_arrays(
    now: int,
    req,
    n_nodes,
    est,
    queued_time,
    avail,
    capacity,
    node_mask=None,
    releases: Sequence[Tuple] = (),
    job_ids: Optional[Sequence[str]] = None,
    resource_types: Sequence[str] = (),
) -> DispatchContext:
    """Hand-built context from plain arrays — e.g. another engine's
    context replayed through this package's planners, one event at a
    time.

    ``releases`` are ``(time, nodes, vec)`` tuples; ``job_ids`` name the
    queued jobs (queue index as a string by default), which stand in the
    context as detached :class:`Job` façades built from the arrays.
    """
    req = np.array(req, dtype=np.int64).reshape(len(n_nodes),
                                                np.shape(avail)[1])
    n_nodes = np.array(n_nodes, dtype=np.int64)
    est = np.array(est, dtype=np.int64)
    queued_time = np.array(queued_time, dtype=np.int64)
    if job_ids is None:
        job_ids = [str(i) for i in range(req.shape[0])]
    jobs = tuple(
        Job(id=job_ids[i], user_id=0, submission_time=int(queued_time[i]),
            duration=int(est[i]), expected_duration=int(est[i]),
            requested_nodes=int(n_nodes[i]),
            requested_resources={rt: int(v) for rt, v in
                                 zip(resource_types, req[i])},
            queued_time=int(queued_time[i]))
        for i in range(req.shape[0]))
    events = tuple(
        ReleaseEvent(time=int(t), nodes=np.array(nodes, dtype=np.int64),
                     vec=np.array(vec, dtype=np.int64), job=None)
        for t, nodes, vec in releases)
    return DispatchContext(
        now=int(now), req=req, n_nodes=n_nodes, est=est,
        queued_time=queued_time, avail=np.array(avail, dtype=np.int64),
        capacity=np.array(capacity, dtype=np.int64),
        resource_types=tuple(resource_types),
        node_mask=None if node_mask is None
        else np.array(node_mask, dtype=bool),
        _jobs=jobs, _releases=events)


class LazySkips(MutableMapping):
    """``DispatchPlan.skips`` mapping with O(1) bulk deferral.

    Blocking policies mark every queued job behind the first failure as
    ``"blocked"`` — labeling those eagerly is an O(queue) Python loop per
    event, the exact per-entity cost the array-native core removes.
    Planners instead :meth:`defer` one ``(ids_fn, reason)`` batch; the
    ids are materialized only if somebody actually reads the mapping
    (tests, queue-jumping debugging — paper §6).

    Deliberately NOT a ``dict`` subclass: C-level consumers
    (``dict(m)``, ``{**m}``, ``json.dumps``) would bypass overridden
    methods on a subclass and silently see the un-materialized storage;
    through the MutableMapping protocol they all resolve via
    ``keys``/``__getitem__`` and observe the full mapping.

    Deferred thunks resolve job ids from live table rows.  Each batch
    carries a staleness guard: reading the mapping after those rows were
    recycled (e.g. ``sim.last_plan.skips`` long after the run) raises
    ``RuntimeError`` instead of returning another job's id.
    """

    __slots__ = ("_data", "_deferred")

    def __init__(self, *args, **kw) -> None:
        self._data: Dict[str, str] = dict(*args, **kw)
        self._deferred: List = []

    def defer(self, ids_fn, reason: str, guard_fn=None) -> None:
        """Queue a ``(ids_fn, reason)`` batch.  ``guard_fn`` (optional)
        is called at materialize time and must return True while the ids
        are still resolvable."""
        self._deferred.append((ids_fn, reason, guard_fn))

    def _materialize(self) -> None:
        if self._deferred:
            batches, self._deferred = self._deferred, []
            for ids_fn, reason, guard_fn in batches:
                if guard_fn is not None and not guard_fn():
                    raise RuntimeError(
                        "plan.skips was read after the queued jobs' table "
                        "rows were recycled; read skips at the event point "
                        "it was planned for")
                for jid in ids_fn():
                    self._data[jid] = reason

    def __len__(self):
        self._materialize()
        return len(self._data)

    def __iter__(self):
        self._materialize()
        return iter(self._data)

    def __contains__(self, k):
        self._materialize()
        return k in self._data

    def __getitem__(self, k):
        self._materialize()
        return self._data[k]

    def __setitem__(self, k, v):
        self._materialize()
        self._data[k] = v

    def __delitem__(self, k):
        self._materialize()
        del self._data[k]

    def __repr__(self):
        self._materialize()
        return repr(self._data)

    def copy(self):
        self._materialize()
        return dict(self._data)


@dataclass
class DispatchPlan:
    """A dispatcher's answer for one event point (replaces the bare
    ``Decision`` tuple).

    ``starts`` and ``rejects`` carry the decision; ``skips`` explains why
    each remaining queued job was *not* started (queue-jumping debugging,
    paper §6); ``stats`` carries per-event instrumentation — most
    importantly ``kernel_launches``, the number of kernel-layer launches
    this plan cost (O(1) in queue length on the batched path).
    """

    starts: List[Tuple[Job, List[int]]] = field(default_factory=list)
    rejects: List[Job] = field(default_factory=list)
    skips: Dict[str, str] = field(default_factory=dict)
    stats: Dict[str, float] = field(default_factory=dict)

    # ------------------------------------------------------------------
    def as_decision(self) -> Tuple[List[Tuple[Job, List[int]]], List[Job]]:
        """Downgrade to the legacy ``(to_start, to_reject)`` tuple."""
        return self.starts, self.rejects

    def start_ids(self) -> List[str]:
        return [job.id for job, _ in self.starts]

    def trace(self) -> List[Tuple[str, Tuple[int, ...]]]:
        """Canonical (job id, node tuple) trace for equality tests."""
        return [(job.id, tuple(nodes)) for job, nodes in self.starts]

    @property
    def n_started(self) -> int:
        return len(self.starts)
