"""Event manager — the discrete-event core of the simulator (paper §3).

Drives jobs through LOADED -> QUEUED -> RUNNING -> COMPLETED using three
event kinds: submission (T_sb, from the workload), start (T_st, decided by
the dispatcher) and completion (T_c = T_st + duration, known only here —
never exposed to the dispatcher).

Array-native core (DESIGN.md §4): the manager is an *index machine* over
the :class:`~repro_torch.core.jobtable.JobTable` column store.  The LOADED and
completion heaps hold plain ``(time, seq, row)`` integer tuples, the
FIFO queue is a numpy ring buffer of row indices (tombstoned removals,
one boolean-mask gather per event), and a completion batch releases its
resources as ONE vectorized scatter-add on ``ResourceManager.available``
instead of per-job ``release()`` calls.  ``Job`` façades are only
materialized where the legacy API needs them (dispatcher plans, output
records, monitors).

Scalability design (paper's headline feature): jobs are pulled
*incrementally* from the workload source — only jobs whose submission time
falls inside a sliding look-ahead window are materialized — and completed
jobs' table rows are recycled after their record is written, so memory
stays ~flat in workload size.
"""
from __future__ import annotations

import heapq
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from .job import Job, JobState
from .jobtable import JobTable, UNSET
from .resources import ResourceManager

# a workload source yields table row indices (hot path), Job façades
# (legacy/tests), or anything JobTable.adopt understands
SourceItem = Union[int, Job]

_EMPTY_ROWS = np.zeros(0, dtype=np.int64)


class EventManager:
    """Owns simulation time, the job table, and the event queues."""

    # Failure-schedule state as CLASS-level defaults: instances restored
    # through ``HostSnapshot`` (built via ``__new__``) degrade gracefully
    # to "no failure schedule" instead of raising AttributeError.
    _fail_t: Optional[np.ndarray] = None    # int64[E] event times (sorted)
    _fail_node: Optional[np.ndarray] = None
    _fail_kind: Optional[np.ndarray] = None  # True = FAIL, False = REPAIR
    _fcursor: int = 0
    _ckpt = None                             # CheckpointRestartPolicy | None
    quarantine_s: int = 0
    n_requeued: int = 0
    lost_work_s: int = 0
    node_downtime_s: int = 0
    # telemetry phase counter (DESIGN.md §10): schedule entries consumed
    # by ``_process_failures`` — no-op duplicates included, matching the
    # fleet engine's failure-drain pointer delta
    n_fail_drain_trips: int = 0

    def __init__(
        self,
        job_source: Iterator[SourceItem],
        resource_manager: ResourceManager,
        lookahead_jobs: int = 8192,
        on_complete: Optional[Callable[[Job], None]] = None,
        table: Optional[JobTable] = None,
    ) -> None:
        self.rm = resource_manager
        self.table = table if table is not None \
            else JobTable(resource_manager.resource_types)
        self._source = iter(job_source)
        self._lookahead = max(1, lookahead_jobs)
        self._on_complete = on_complete

        self.current_time: int = 0
        self.loaded: List[Tuple[int, int, int]] = []   # heap (T_sb, seq, row)
        # FIFO queue as a numpy ring buffer with tombstones: append at
        # _qtail, arbitrary removal via the row -> position map, one
        # boolean-mask gather for the whole queue (no per-entry Python)
        self._qbuf = np.empty(1024, dtype=np.int64)
        self._qlive = np.zeros(1024, dtype=bool)
        self._qhead = 0
        self._qtail = 0
        self._qpos: Dict[int, int] = {}
        self._running: set = set()
        self._completions: List[Tuple[int, int, int]] = []  # (T_c, seq, row)
        self._seq = 0
        self._exhausted = False
        # counters (memory-light aggregates; full records go to the output)
        self.n_submitted = 0
        self.n_completed = 0
        self.n_rejected = 0
        self._refill()

    # ------------------------------------------------------------------ load
    def _refill(self) -> None:
        """Incremental job loading: top the LOADED buffer up to the window."""
        table = self.table
        while not self._exhausted and len(self.loaded) < self._lookahead:
            try:
                item = next(self._source)
            except StopIteration:
                self._exhausted = True
                return
            if isinstance(item, (int, np.integer)):
                row = int(item)
            else:
                row = table.adopt(item)
            table.state[row] = JobState.LOADED
            heapq.heappush(self.loaded,
                           (int(table.submit[row]), self._seq, row))
            self._seq += 1

    # ------------------------------------------------------------------ fail
    def set_failure_schedule(self, times, nodes, is_fail, *,
                             checkpoint=None, quarantine_s: int = 0) -> None:
        """Install a precomputed node FAIL/REPAIR event trace (e.g.
        ``FailureInjector.arrays()``) as a native event source.

        A FAIL event marks the node down + quarantined, preempts every
        job assigned to it and re-queues the victims (``requeue_job``),
        with ``checkpoint`` (a ``CheckpointRestartPolicy``) deciding the
        remaining duration; a REPAIR marks it back up.  Quarantine is
        time-based — a node is dispatch-eligible iff it is up AND its
        quarantine deadline has passed (:meth:`node_eligibility`) — and
        deliberately does NOT mutate ``ResourceManager`` capacity, so
        the static capacity-fit check stays valid (DESIGN.md §9).

        Call right after construction, before the first ``advance_to``;
        events at or before the current time would be skipped.
        """
        times = np.ascontiguousarray(times, dtype=np.int64)
        nodes = np.ascontiguousarray(nodes, dtype=np.int64)
        is_fail = np.ascontiguousarray(is_fail, dtype=bool)
        if not (times.shape == nodes.shape == is_fail.shape):
            raise ValueError("failure schedule arrays must share a shape")
        if times.size and (np.diff(times) < 0).any():
            raise ValueError("failure schedule must be sorted by time")
        self._fail_t = times
        self._fail_node = nodes
        self._fail_kind = is_fail
        self._fcursor = 0
        self._ckpt = checkpoint
        self.quarantine_s = int(quarantine_s)
        n = self.rm.capacity.shape[0]
        self._node_up = np.ones(n, dtype=bool)
        self._quar_until = np.zeros(n, dtype=np.int64)
        self._down_since = np.full(n, -1, dtype=np.int64)
        self.n_requeued = 0
        self.lost_work_s = 0
        self.node_downtime_s = 0
        self.n_fail_drain_trips = 0
        # per-row last-enqueue stamps: victims re-enter the FIFO ring in
        # their previous enqueue order (the fleet engine re-ranks by old
        # fifo_rank — same relative order)
        self._enq_stamp: Dict[int, int] = {}
        self._rank_ctr = 0

    def node_eligibility(self, now: int) -> Optional[np.ndarray]:
        """bool[N] dispatch-eligibility mask (None without a schedule):
        a node takes new work iff it is up and out of quarantine."""
        if self._fail_t is None:
            return None
        return self._node_up & (self._quar_until <= now)

    def _process_failures(self, t: int) -> None:
        """Apply every FAIL/REPAIR event at or before ``t`` (called from
        ``advance_to`` between completions and submissions, so same-time
        completions escape the failure and victims re-enter the queue
        ahead of same-time submissions)."""
        table = self.table
        fail_t, fail_node, fail_kind = \
            self._fail_t, self._fail_node, self._fail_kind
        while self._fcursor < len(fail_t) and \
                fail_t[self._fcursor] <= t:
            i = self._fcursor
            self._fcursor += 1
            self.n_fail_drain_trips += 1
            ev_t = int(fail_t[i])
            v = int(fail_node[i])
            if fail_kind[i]:                 # ---- FAIL
                if not self._node_up[v]:
                    continue                 # duplicate fail: no-op
                self._node_up[v] = False
                self._down_since[v] = ev_t
                self._quar_until[v] = ev_t + self.quarantine_s
                victims = [r for r in self._running
                           if v in table.assigned(r)]
                victims.sort(key=lambda r: self._enq_stamp.get(r, 0))
                for row in victims:
                    ran = ev_t - int(table.start_time[row])
                    dur0 = int(table.duration[row])
                    job = table.view(row)
                    self.requeue_job(job)
                    saved = 0
                    if self._ckpt is not None:
                        self._ckpt.on_requeue(job, ran)
                        saved = dur0 - int(table.duration[row])
                    self.n_requeued += 1
                    self.lost_work_s += ran - saved
            else:                            # ---- REPAIR
                if self._node_up[v]:
                    continue                 # repair of an up node: no-op
                self._node_up[v] = True
                self.node_downtime_s += ev_t - int(self._down_since[v])
                self._down_since[v] = -1

    # ------------------------------------------------------------------ time
    def next_event_time(self) -> Optional[int]:
        t: Optional[int] = None
        if self.loaded:
            t = self.loaded[0][0]
            if self._completions and self._completions[0][0] < t:
                t = self._completions[0][0]
        elif self._completions:
            t = self._completions[0][0]
        # a pending FAIL/REPAIR is a wake-up only while it can affect
        # anything (jobs running or queued) — trailing schedule events
        # after the last job must not keep an idle simulation alive
        if self._fail_t is not None and \
                self._fcursor < len(self._fail_t) and \
                (self._running or self._qpos):
            ft = int(self._fail_t[self._fcursor])
            t = ft if t is None else min(t, ft)
        return t

    def has_events(self) -> bool:
        return bool(self.loaded or self._completions or self._qpos)

    # ------------------------------------------------------------------ queue
    def _enqueue(self, row: int) -> None:
        if self._qtail == self._qbuf.shape[0]:
            self._compact_or_grow()
        pos = self._qtail
        self._qbuf[pos] = row
        self._qlive[pos] = True
        self._qpos[row] = pos
        self._qtail = pos + 1
        if self._fail_t is not None:
            self._enq_stamp[row] = self._rank_ctr
            self._rank_ctr += 1

    def _dequeue(self, row: int) -> None:
        pos = self._qpos.pop(row, None)
        if pos is None:
            raise ValueError(f"job {self.table.ids[row]} is not queued")
        self._qlive[pos] = False

    def _compact_or_grow(self) -> None:
        live = self.queue_rows()
        n = live.shape[0]
        if n >= self._qbuf.shape[0] // 2:
            cap = self._qbuf.shape[0] * 2
            self._qbuf = np.empty(cap, dtype=np.int64)
            self._qlive = np.zeros(cap, dtype=bool)
        else:
            self._qlive[:] = False
        self._qbuf[:n] = live
        self._qlive[:n] = True
        self._qpos = {int(r): i for i, r in enumerate(live)}
        self._qhead = 0
        self._qtail = n

    # ------------------------------------------------------------------ views
    @property
    def n_queued(self) -> int:
        return len(self._qpos)

    @property
    def n_running(self) -> int:
        return len(self._running)

    def queue_rows(self) -> np.ndarray:
        """int64[J]: queued rows in FIFO arrival order."""
        head, tail = self._qhead, self._qtail
        if len(self._qpos) == tail - head:
            return self._qbuf[head:tail].copy()
        return self._qbuf[head:tail][self._qlive[head:tail]]

    def running_rows(self) -> np.ndarray:
        """int64[K]: running rows (unordered)."""
        return np.fromiter(self._running, dtype=np.int64,
                           count=len(self._running))

    @property
    def queue(self) -> List[Job]:
        """Legacy view: queued jobs as façades, FIFO order (a fresh list —
        use :meth:`queue_rows` / :attr:`n_queued` on hot paths)."""
        view = self.table.view
        return [view(int(r)) for r in self.queue_rows()]

    @property
    def running(self) -> Dict[str, Job]:
        """Legacy view: running jobs keyed by id (a fresh dict)."""
        view = self.table.view
        out = {}
        for r in self._running:
            job = view(r)
            out[job.id] = job
        return out

    # ------------------------------------------------------------------ step
    def advance_to(self, t: int) -> Tuple[List[int], List[int]]:
        """Move simulation time to ``t``; process completions then
        submissions scheduled at (or before) ``t``.

        Returns ``(completed_rows, submitted_rows)`` — table row indices.
        Completed rows are recycled before this returns; any cached
        façade is detached with its final values.
        """
        assert t >= self.current_time, "time must be monotone"
        self.current_time = t
        table = self.table

        completed: List[int] = []
        comps = self._completions
        while comps and comps[0][0] <= t:
            _, _, row = heapq.heappop(comps)
            self._running.discard(row)
            table.state[row] = JobState.COMPLETED
            completed.append(row)
        if completed:
            self.rm.release_rows(table, completed)
            self.n_completed += len(completed)
            on_complete = self._on_complete
            for row in completed:
                if on_complete is not None:
                    on_complete(table.view(row))
                table.free_row(row)

        if self._fail_t is not None:
            self._process_failures(t)

        submitted: List[int] = []
        loaded = self.loaded
        while loaded and loaded[0][0] <= t:
            _, _, row = heapq.heappop(loaded)
            table.state[row] = JobState.QUEUED
            table.queued_time[row] = t
            self._enqueue(row)
            self.n_submitted += 1
            submitted.append(row)
            self._refill()
        return completed, submitted

    # ------------------------------------------------------------------ start
    def start_job(self, job: Job, nodes) -> None:
        """Execute a dispatching decision: allocate + schedule completion."""
        if not job.bound or job._table is not self.table:
            raise ValueError(f"job {job.id} is not managed by this manager")
        self.start_row(job._row, nodes)

    def start_row(self, row: int, nodes) -> None:
        table = self.table
        if row not in self._qpos:
            raise ValueError(f"job {table.ids[row]} is not queued")
        t = self.current_time
        idx = np.asarray(nodes, dtype=np.int64)
        # allocate BEFORE dequeuing: a failed allocation (over-commit,
        # duplicate nodes) must leave the queue untouched
        self.rm.commit_allocation(table.ids[row], idx, table.req[row],
                                  int(table.requested_nodes[row]))
        self._dequeue(row)
        table.state[row] = JobState.RUNNING
        table.start_time[row] = t
        end = t + int(table.duration[row])
        table.end_time[row] = end
        table._assigned[row] = idx
        self._running.add(row)
        heapq.heappush(self._completions, (end, self._seq, row))
        self._seq += 1

    def reject_job(self, job: Job) -> None:
        if not job.bound or job._table is not self.table:
            raise ValueError(f"job {job.id} is not managed by this manager")
        self.reject_row(job._row)

    def reject_row(self, row: int) -> None:
        table = self.table
        self._dequeue(row)
        table.state[row] = JobState.REJECTED
        self.n_rejected += 1
        if self._on_complete is not None:
            self._on_complete(table.view(row))
        table.free_row(row)

    def requeue_job(self, job: Job) -> None:
        """Pull a RUNNING job back into the queue (node failure /
        checkpoint-restart path): release its resources, cancel its
        completion event, reset its start/end state."""
        if not job.bound or job._table is not self.table:
            raise ValueError(f"job {job.id} is not managed by this manager")
        row = job._row
        if row not in self._running:
            raise ValueError(f"job {job.id} is not running")
        table = self.table
        self._running.discard(row)
        self._completions = [(e, s, r) for e, s, r in self._completions
                             if r != row]
        heapq.heapify(self._completions)
        self.rm.release_allocation(table.assigned(row), table.req[row])
        table.state[row] = JobState.QUEUED
        table.start_time[row] = UNSET
        table.end_time[row] = UNSET
        table._assigned.pop(row, None)
        self._enqueue(row)

    # ------------------------------------------------------------------ views
    def system_status(self) -> Dict[str, object]:
        """Current system status exposed to dispatchers & the monitor tool."""
        return {
            "time": self.current_time,
            "queued": self.n_queued,
            "running": self.n_running,
            "completed": self.n_completed,
            "rejected": self.n_rejected,
            "submitted": self.n_submitted,
            "resources": self.rm.snapshot(),
        }

    def release_times(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(rows, est_release)`` for running jobs — dispatcher view:
        walltime estimates, never true durations; a job may overrun its
        estimate, so from 'now' it releases no earlier than the next
        tick."""
        if not self._running:
            return _EMPTY_ROWS, _EMPTY_ROWS
        rows = self.running_rows()
        table = self.table
        est = table.start_time[rows] + \
            np.maximum(table.expected_duration[rows], 1)
        return rows, np.maximum(est, self.current_time + 1)

    def running_release_times(self) -> List[Tuple[int, Job]]:
        """Legacy view: (estimated release time, job façade) pairs."""
        rows, est = self.release_times()
        view = self.table.view
        return [(int(t), view(int(r))) for r, t in zip(rows, est)]
