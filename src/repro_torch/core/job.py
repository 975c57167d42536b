"""Job model for the AccaSim-style workload management simulator.

A job follows the paper's life-cycle::

    LOADED -> QUEUED -> RUNNING -> COMPLETED
                  \\-> REJECTED          (rejecting dispatcher / invalid)

The dispatcher never sees ``duration`` (the true runtime) — only
``expected_duration`` (the user-supplied walltime estimate), mirroring the
paper's separation between the event manager (which knows T_c) and the
dispatcher (which only knows estimates).

Since the array-native refactor (DESIGN.md §4) job state lives in the
:class:`~repro_torch.core.jobtable.JobTable` column store; ``Job`` is a thin
*row-view façade* over one table row.  A ``Job`` constructed directly
(tests, custom factories, examples) starts *detached* — its fields live
in a local dict exactly like the old dataclass — and is *bound* when the
event manager adopts it into the table, after which every attribute read
and write goes straight to the table columns.  When the row is recycled
(job completed/rejected and its record written) the façade detaches
again, keeping its final values, so held references stay valid.
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional

_UNSET = -1   # int64 sentinel for "time not set" (matches jobtable.UNSET)


class JobState(enum.IntEnum):
    LOADED = 0
    QUEUED = 1
    RUNNING = 2
    COMPLETED = 3
    REJECTED = 4


def _time_get(raw: int) -> Optional[int]:
    return None if raw == _UNSET else int(raw)


class Job:
    """A job record façade (detached dict or bound JobTable row view)."""

    __slots__ = ("_table", "_row", "_local")

    def __init__(
        self,
        id: str,
        user_id: int,
        submission_time: int,
        duration: int,
        expected_duration: int,
        requested_nodes: int,
        requested_resources: Dict[str, int],
        attrs: Optional[Dict[str, object]] = None,
        state: JobState = JobState.LOADED,
        queued_time: Optional[int] = None,
        start_time: Optional[int] = None,
        end_time: Optional[int] = None,
        assigned_nodes: Optional[List[int]] = None,
    ) -> None:
        if duration < 0:
            raise ValueError(f"job {id}: negative duration {duration}")
        if requested_nodes <= 0:
            raise ValueError(f"job {id}: must request >= 1 node")
        if expected_duration < 0:
            expected_duration = duration
        self._table = None
        self._row = -1
        self._local = {
            "id": str(id),
            "user_id": int(user_id),
            "submission_time": int(submission_time),
            "duration": int(duration),
            "expected_duration": int(expected_duration),
            "requested_nodes": int(requested_nodes),
            "requested_resources": dict(requested_resources),
            "attrs": dict(attrs) if attrs else {},
            "state": JobState(state),
            "queued_time": queued_time,
            "start_time": start_time,
            "end_time": end_time,
            "assigned_nodes": list(assigned_nodes) if assigned_nodes else [],
        }

    # ----- binding lifecycle ------------------------------------------
    @classmethod
    def _from_row(cls, table, row: int) -> "Job":
        job = cls.__new__(cls)
        job._table = table
        job._row = row
        job._local = None
        return job

    @property
    def bound(self) -> bool:
        return self._table is not None

    def _bind(self, table, row: int) -> None:
        """Called by ``JobTable.adopt`` AFTER the row was filled from the
        local values; the table becomes authoritative."""
        self._table = table
        self._row = row
        self._local = None

    def _detach(self) -> None:
        """Snapshot the row back into local storage (row is about to be
        recycled).  The table clears its own references right after, so
        the resources/attrs dicts transfer by reference, not copy."""
        t, r = self._table, self._row
        attrs = t._attrs.get(r)
        self._local = {
            "id": t.ids[r],
            "user_id": int(t.user_id[r]),
            "submission_time": int(t.submit[r]),
            "duration": int(t.duration[r]),
            "expected_duration": int(t.expected_duration[r]),
            "requested_nodes": int(t.requested_nodes[r]),
            "requested_resources": t.resources_of(r),
            "attrs": attrs if attrs is not None else {},
            "state": JobState(int(t.state[r])),
            "queued_time": _time_get(t.queued_time[r]),
            "start_time": _time_get(t.start_time[r]),
            "end_time": _time_get(t.end_time[r]),
            "assigned_nodes": [int(n) for n in t.assigned(r)],
        }
        self._table = None
        self._row = -1

    # ----- scalar accessors -------------------------------------------
    @property
    def id(self) -> str:
        return self._table.ids[self._row] if self._table is not None \
            else self._local["id"]

    @id.setter
    def id(self, v: str) -> None:
        if self._table is not None:
            self._table.ids[self._row] = str(v)
        else:
            self._local["id"] = str(v)

    @property
    def user_id(self) -> int:
        return int(self._table.user_id[self._row]) \
            if self._table is not None else self._local["user_id"]

    @user_id.setter
    def user_id(self, v: int) -> None:
        if self._table is not None:
            self._table.user_id[self._row] = int(v)
        else:
            self._local["user_id"] = int(v)

    @property
    def submission_time(self) -> int:
        return int(self._table.submit[self._row]) \
            if self._table is not None else self._local["submission_time"]

    @submission_time.setter
    def submission_time(self, v: int) -> None:
        if self._table is not None:
            self._table.submit[self._row] = int(v)
        else:
            self._local["submission_time"] = int(v)

    @property
    def duration(self) -> int:
        return int(self._table.duration[self._row]) \
            if self._table is not None else self._local["duration"]

    @duration.setter
    def duration(self, v: int) -> None:
        if self._table is not None:
            self._table.duration[self._row] = int(v)
        else:
            self._local["duration"] = int(v)

    @property
    def expected_duration(self) -> int:
        return int(self._table.expected_duration[self._row]) \
            if self._table is not None else self._local["expected_duration"]

    @expected_duration.setter
    def expected_duration(self, v: int) -> None:
        if self._table is not None:
            self._table.expected_duration[self._row] = int(v)
        else:
            self._local["expected_duration"] = int(v)

    @property
    def requested_nodes(self) -> int:
        return int(self._table.requested_nodes[self._row]) \
            if self._table is not None else self._local["requested_nodes"]

    @requested_nodes.setter
    def requested_nodes(self, v: int) -> None:
        if self._table is not None:
            self._table.requested_nodes[self._row] = int(v)
        else:
            self._local["requested_nodes"] = int(v)

    @property
    def requested_resources(self) -> Dict[str, int]:
        if self._table is not None:
            return self._table.resources_of(self._row)
        return self._local["requested_resources"]

    @requested_resources.setter
    def requested_resources(self, d: Dict[str, int]) -> None:
        if self._table is not None:
            self._table._resources[self._row] = dict(d)
            self._table.fill_request(self._row, d)
        else:
            self._local["requested_resources"] = dict(d)

    @property
    def attrs(self) -> Dict[str, object]:
        if self._table is not None:
            return self._table.attrs_of(self._row)
        return self._local["attrs"]

    @property
    def state(self) -> JobState:
        return JobState(int(self._table.state[self._row])) \
            if self._table is not None else self._local["state"]

    @state.setter
    def state(self, v: JobState) -> None:
        if self._table is not None:
            self._table.state[self._row] = int(v)
        else:
            self._local["state"] = JobState(v)

    @property
    def queued_time(self) -> Optional[int]:
        return _time_get(self._table.queued_time[self._row]) \
            if self._table is not None else self._local["queued_time"]

    @queued_time.setter
    def queued_time(self, v: Optional[int]) -> None:
        if self._table is not None:
            self._table.queued_time[self._row] = _UNSET if v is None else v
        else:
            self._local["queued_time"] = v

    @property
    def start_time(self) -> Optional[int]:
        return _time_get(self._table.start_time[self._row]) \
            if self._table is not None else self._local["start_time"]

    @start_time.setter
    def start_time(self, v: Optional[int]) -> None:
        if self._table is not None:
            self._table.start_time[self._row] = _UNSET if v is None else v
        else:
            self._local["start_time"] = v

    @property
    def end_time(self) -> Optional[int]:
        return _time_get(self._table.end_time[self._row]) \
            if self._table is not None else self._local["end_time"]

    @end_time.setter
    def end_time(self, v: Optional[int]) -> None:
        if self._table is not None:
            self._table.end_time[self._row] = _UNSET if v is None else v
        else:
            self._local["end_time"] = v

    @property
    def assigned_nodes(self) -> List[int]:
        if self._table is not None:
            return [int(n) for n in self._table.assigned(self._row)]
        return self._local["assigned_nodes"]

    @assigned_nodes.setter
    def assigned_nodes(self, nodes: List[int]) -> None:
        if self._table is not None:
            self._table.set_assigned(self._row, nodes)
        else:
            self._local["assigned_nodes"] = list(nodes) if nodes else []

    # ----- convenience -------------------------------------------------
    @property
    def completion_time(self) -> Optional[int]:
        return self.end_time

    def expected_end(self, now: int) -> int:
        """Estimated completion if started at ``now`` (dispatcher view)."""
        return now + max(self.expected_duration, 1)

    @property
    def waiting_time(self) -> Optional[int]:
        if self.start_time is None:
            return None
        return self.start_time - self.submission_time

    @property
    def slowdown(self) -> Optional[float]:
        """Paper §7.2: slowdown_j = (T_w + T_r) / T_r."""
        if self.start_time is None:
            return None
        run = max(self.duration, 1)
        return (self.waiting_time + run) / run

    def __repr__(self) -> str:
        mode = f"row={self._row}" if self._table is not None else "detached"
        return (f"Job(id={self.id!r}, state={self.state.name}, "
                f"submit={self.submission_time}, nodes={self.requested_nodes},"
                f" {mode})")

    def to_record(self) -> Dict[str, object]:
        """Flat record for the simulator output file (first output type)."""
        return {
            "id": self.id,
            "user": self.user_id,
            "submit": self.submission_time,
            "start": self.start_time,
            "end": self.end_time,
            "duration": self.duration,
            "expected_duration": self.expected_duration,
            "nodes": self.requested_nodes,
            "resources": dict(self.requested_resources),
            "assigned": list(self.assigned_nodes),
            "waiting": self.waiting_time,
            "slowdown": self.slowdown,
            "state": self.state.name,
        }


class JobFactory:
    """Creates jobs from parsed workload records.

    The default mapping consumes records produced by the SWF reader
    (``repro_torch.workloads.swf``). ``extra_attributes`` lets users attach
    additional per-job data (e.g. power estimates) as the paper's job
    factory does.

    Two entry points: :meth:`from_record` (legacy; a detached ``Job``
    object) and :meth:`fill_row` (the hot path; writes a ``JobTable``
    row directly — no per-job Python object at all).
    """

    def __init__(self, resource_mapper=None, extra_attributes=None) -> None:
        self._mapper = resource_mapper
        self._extra = extra_attributes or {}

    def _request(self, rec: Dict[str, object]):
        if self._mapper is not None:
            return self._mapper(rec)
        nodes = int(rec.get("requested_nodes", 1)) or 1
        per_node = dict(rec.get("requested_resources", {"core": 1}))
        return nodes, per_node

    def from_record(self, rec: Dict[str, object]) -> Job:
        nodes, per_node = self._request(rec)
        job = Job(
            id=str(rec["id"]),
            user_id=int(rec.get("user", -1)),
            submission_time=int(rec["submit"]),
            duration=max(int(rec["duration"]), 0),
            expected_duration=int(rec.get("expected_duration", rec["duration"])),
            requested_nodes=nodes,
            requested_resources=per_node,
        )
        for key, fn in self._extra.items():
            job.attrs[key] = fn(rec)
        return job

    def fill_row(self, table, rec: Dict[str, object]) -> int:
        """Append ``rec`` directly as a table row; returns the row index."""
        nodes, per_node = self._request(rec)
        row = table.add(
            id=str(rec["id"]),
            user_id=int(rec.get("user", -1)),
            submission_time=int(rec["submit"]),
            duration=max(int(rec["duration"]), 0),
            expected_duration=int(rec.get("expected_duration",
                                          rec["duration"])),
            requested_nodes=nodes,
            requested_resources=per_node,
        )
        if self._extra:
            attrs = table.attrs_of(row)
            for key, fn in self._extra.items():
                attrs[key] = fn(rec)
        return row


def swf_resource_mapper(cores_per_node: int, mem_per_node: int = 0):
    """Map an SWF record (total processors + total memory) onto the
    node-spanning request model: ``requested_nodes`` nodes, each with an
    identical per-node resource vector (AccaSim's representation)."""

    def mapper(rec: Dict[str, object]):
        procs = max(int(rec.get("requested_processors", 1)), 1)
        mem = max(int(rec.get("requested_memory", 0)), 0)
        nodes = max(1, -(-procs // cores_per_node))  # ceil division
        per_node = {"core": -(-procs // nodes)}
        if mem_per_node > 0:
            per_node["mem"] = min(mem_per_node, -(-mem // nodes)) if mem else 0
        return nodes, per_node

    return mapper
