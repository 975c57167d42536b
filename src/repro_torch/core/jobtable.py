"""Structure-of-arrays job store — the single source of truth for job
state in the simulation core (DESIGN.md §4).

Every per-job scalar lives in a growable int64 column (``submit``,
``duration``, ``expected_duration``, ``requested_nodes``, ``user_id``,
``state``, ``queued_time``, ``start_time``, ``end_time``; ``-1`` encodes
"not yet") and the dense per-node request matrix ``req [capacity, R]``
is filled once at load time.  The event manager and the dispatch-context
builder operate on *row indices* against these columns — one numpy op
over a row batch instead of a Python loop over ``Job`` objects.

Rows are recycled: when a job leaves the simulation (completed or
rejected, its output record written) its row returns to a free list and
is reused for the next loaded job, so table memory is bounded by the
number of *live* jobs (LOADED window + queue + running) — the paper's
~flat-memory scalability claim survives the refactor.

The legacy :class:`~repro_torch.core.job.Job` API survives as a row-view
façade: :meth:`view` returns a cached ``Job`` whose attribute reads and
writes go straight to the table columns.  When a row is freed, any
outstanding façade is *detached* — its current values are copied into
the façade's local storage — so references held by user code (monitors,
tests, plan post-mortems) remain valid snapshots.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# int64 sentinel for "time not set" (queued/start/end before they happen)
UNSET = -1

# scalar columns, in table attribute order
_INT_COLS = ("submit", "duration", "expected_duration", "requested_nodes",
             "user_id", "state", "queued_time", "start_time", "end_time")


class JobTable:
    """Growable SoA column store over jobs, keyed by row index."""

    def __init__(self, resource_types: Sequence[str],
                 initial_capacity: int = 1024) -> None:
        self.resource_types: Tuple[str, ...] = tuple(resource_types)
        self.rt_index: Dict[str, int] = {
            rt: i for i, rt in enumerate(self.resource_types)}
        cap = max(int(initial_capacity), 16)
        self._cap = cap
        for col in _INT_COLS:
            setattr(self, col, np.zeros(cap, dtype=np.int64))
        self.req = np.zeros((cap, len(self.resource_types)), dtype=np.int64)
        # per-row generation: bumped when a row is recycled, so deferred
        # references (lazy skip labels) can detect staleness precisely
        self.gen = np.zeros(cap, dtype=np.int64)
        self.ids: List[Optional[str]] = [None] * cap
        self._resources: List[Optional[dict]] = [None] * cap
        self._attrs: Dict[int, dict] = {}
        self._assigned: Dict[int, np.ndarray] = {}
        self._views: Dict[int, "Job"] = {}      # row -> cached façade
        self._free: List[int] = []
        self._next = 0                          # high-water mark
        self.n_added = 0                        # lifetime adds
        self.n_recycled = 0                     # lifetime frees (staleness stamp)

    # ------------------------------------------------------------------
    @property
    def capacity_rows(self) -> int:
        return self._cap

    @property
    def n_live(self) -> int:
        return self._next - len(self._free)

    def _grow(self) -> None:
        new_cap = self._cap * 2
        for col in _INT_COLS:
            arr = getattr(self, col)
            grown = np.zeros(new_cap, dtype=np.int64)
            grown[: self._cap] = arr
            setattr(self, col, grown)
        grown_req = np.zeros((new_cap, self.req.shape[1]), dtype=np.int64)
        grown_req[: self._cap] = self.req
        self.req = grown_req
        grown_gen = np.zeros(new_cap, dtype=np.int64)
        grown_gen[: self._cap] = self.gen
        self.gen = grown_gen
        self.ids.extend([None] * (new_cap - self._cap))
        self._resources.extend([None] * (new_cap - self._cap))
        self._cap = new_cap

    def _alloc_row(self) -> int:
        if self._free:
            return self._free.pop()
        if self._next >= self._cap:
            self._grow()
        row = self._next
        self._next += 1
        return row

    # ------------------------------------------------------------------
    def fill_request(self, row: int, resources: Dict[str, int]) -> None:
        """Write the per-node request vector of ``row`` from a dict."""
        self.req[row, :] = 0
        for rt, qty in resources.items():
            col = self.rt_index.get(rt)
            if col is None:
                raise KeyError(
                    f"job {self.ids[row]!r} requests unknown resource {rt!r}")
            self.req[row, col] = int(qty)

    def add(
        self,
        id: str,
        user_id: int,
        submission_time: int,
        duration: int,
        expected_duration: int,
        requested_nodes: int,
        requested_resources: Dict[str, int],
        attrs: Optional[dict] = None,
        state: int = 0,                     # JobState.LOADED
    ) -> int:
        """Append one job; returns its row index.

        Validation mirrors the legacy ``Job`` constructor: negative
        duration and non-positive node counts are errors; a negative
        walltime estimate falls back to the true duration.
        """
        if duration < 0:
            raise ValueError(f"job {id}: negative duration {duration}")
        if requested_nodes <= 0:
            raise ValueError(f"job {id}: must request >= 1 node")
        if expected_duration < 0:
            expected_duration = duration
        row = self._alloc_row()
        self.submit[row] = submission_time
        self.duration[row] = duration
        self.expected_duration[row] = expected_duration
        self.requested_nodes[row] = requested_nodes
        self.user_id[row] = user_id
        self.state[row] = state
        self.queued_time[row] = UNSET
        self.start_time[row] = UNSET
        self.end_time[row] = UNSET
        self.ids[row] = str(id)
        self._resources[row] = dict(requested_resources)
        self.fill_request(row, requested_resources)
        if attrs:
            self._attrs[row] = dict(attrs)
        self.n_added += 1
        return row

    # ------------------------------------------------------------------
    def adopt(self, job: "Job") -> int:
        """Bind a detached façade into the table (its values become a
        table row; subsequent attribute access reads/writes the row)."""
        if job.bound:
            if job._table is self:
                return job._row
            raise ValueError(f"job {job.id} is bound to another table")
        row = self.add(
            id=job.id, user_id=job.user_id,
            submission_time=job.submission_time, duration=job.duration,
            expected_duration=job.expected_duration,
            requested_nodes=job.requested_nodes,
            requested_resources=job.requested_resources,
            attrs=job.attrs or None, state=int(job.state))
        qt, st, et = job.queued_time, job.start_time, job.end_time
        self.queued_time[row] = UNSET if qt is None else qt
        self.start_time[row] = UNSET if st is None else st
        self.end_time[row] = UNSET if et is None else et
        assigned = job.assigned_nodes
        if assigned:
            self._assigned[row] = np.asarray(assigned, dtype=np.int64)
        job._bind(self, row)
        self._views[row] = job
        return row

    def view(self, row: int) -> "Job":
        """Cached row-view façade for ``row`` (created on first use)."""
        job = self._views.get(row)
        if job is None:
            job = Job._from_row(self, row)
            self._views[row] = job
        return job

    def has_view(self, row: int) -> bool:
        return row in self._views

    # ------------------------------------------------------------------
    def assigned(self, row: int) -> np.ndarray:
        return self._assigned.get(row, _EMPTY_NODES)

    def set_assigned(self, row: int, nodes) -> None:
        if nodes is None or len(nodes) == 0:
            self._assigned.pop(row, None)
        else:
            self._assigned[row] = np.asarray(nodes, dtype=np.int64)

    def attrs_of(self, row: int) -> dict:
        d = self._attrs.get(row)
        if d is None:
            d = self._attrs[row] = {}
        return d

    def resources_of(self, row: int) -> Dict[str, int]:
        d = self._resources[row]
        if d is None:
            d = self._resources[row] = {
                rt: int(self.req[row, c])
                for c, rt in enumerate(self.resource_types)
                if self.req[row, c]}
        return d

    # ------------------------------------------------------------------
    def free_row(self, row: int) -> None:
        """Recycle ``row``: detach any outstanding façade (so held
        references keep their final values), clear object refs, return
        the row to the free list."""
        view = self._views.pop(row, None)
        if view is not None:
            view._detach()
        self.ids[row] = None
        self._resources[row] = None
        self._attrs.pop(row, None)
        self._assigned.pop(row, None)
        self._free.append(row)
        self.gen[row] += 1
        self.n_recycled += 1


_EMPTY_NODES = np.zeros(0, dtype=np.int64)

# imported at the bottom so ``from .jobtable import JobTable`` works no
# matter whether job.py or jobtable.py is imported first
from .job import Job  # noqa: E402
