"""Fixed-capacity simulation state — the array image of the core
(DESIGN.md §8).

Two exports live here:

* :class:`SimState` — the *compiled-loop* state: a tuple of
  fixed-capacity arrays (job columns, dense request matrix, node
  availability/capacity, the sorted pending-submission window, the masked
  FIFO queue encoded as per-row ranks, and a per-event log) that
  ``fleet.engine.advance`` runs to the end of the simulation (one CUDA
  thread block per sim, ``csrc/fleet_engine.cuh``) and
  ``fleet.runner.FleetRunner`` stacks along a leading sim axis and
  splits across devices.  Built either straight from a workload
  (:meth:`SimState.from_workload`) or snapshotted from a live
  :class:`~repro_torch.core.events.EventManager` mid-simulation
  (:meth:`SimState.from_event_manager`).

* :class:`HostSnapshot` — the *round-trip* export: everything the host
  engine holds (JobTable columns + free list + row generations, the
  tombstoned queue ring, both event heaps with their sequence numbers,
  ResourceManager availability) as plain arrays, restorable into a live
  ``EventManager`` that behaves identically.  This is the state
  export/import contract the simulation-as-a-service and learned-
  dispatcher work builds on.

The arrays stay numpy here; the runner copies them to the device as
int32 tensors.  Encoding conventions shared with the engine (all int32
on device):

* ``UNSET_I`` (-1) for times not yet set, matching ``jobtable.UNSET``;
* ``INF_I`` (2**30) as the +infinity sentinel for masked minima — far
  above any simulated timestamp, still int32-safe under one addition;
* ``assigned`` is ``[rows, K]`` node indices padded with ``n_nodes``
  (the one-past-the-end "trash" node the engine's padded scatter drops);
* ``pending`` lists row indices in submission order ``(T_sb, seq)``;
  the FIFO queue is not a ring here but a per-row ``fifo_rank`` — ranks
  are assigned in enqueue order, so "masked FIFO queue" = the rows with
  ``state == QUEUED`` ordered by rank.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..core.events import EventManager
from ..core.job import Job, JobFactory, JobState
from ..core.jobtable import JobTable, UNSET, _INT_COLS
from ..core.resources import ResourceManager

UNSET_I = -1
INF_I = np.int32(1 << 30)

# JobState values, mirrored as module constants for the engine
LOADED, QUEUED, RUNNING, COMPLETED, REJECTED = (
    int(JobState.LOADED), int(JobState.QUEUED), int(JobState.RUNNING),
    int(JobState.COMPLETED), int(JobState.REJECTED))


class SimState(NamedTuple):
    """Device-ready fixed-capacity simulation state.

    Every field is an array (scalars are 0-d int32) so the whole tuple
    stacks along a leading sim axis into one int32 tensor per field,
    which the engine updates in place.  The same tuple type carries
    torch tensors (one sim, or stacked) inside ``fleet.engine``.  Shapes,
    with
    ``M`` = row capacity, ``N`` = nodes, ``R`` = resource types,
    ``K`` = max requested node count, ``E = 2M + 8`` = event-log slots:
    """

    # --- job columns [M] ------------------------------------------------
    submit: np.ndarray            # submission times (INF_I on pad rows)
    duration: np.ndarray          # true runtimes (event-manager-only)
    est: np.ndarray               # walltime estimates, >= 1 (dispatcher view)
    n_need: np.ndarray            # requested node counts
    state: np.ndarray             # JobState codes
    queued_time: np.ndarray       # UNSET_I until queued
    start: np.ndarray             # UNSET_I until started
    end: np.ndarray               # UNSET_I until started (then T_c)
    fifo_rank: np.ndarray         # enqueue order; INF_I until queued
    unfit: np.ndarray             # 1 = can never fit (reject at submission)
    # --- matrices -------------------------------------------------------
    req: np.ndarray               # [M, R] per-node request matrix
    assigned: np.ndarray          # [M, K] node ids, padded with N
    avail: np.ndarray             # [N, R] current availability
    capacity: np.ndarray          # [N, R] node capacities (constant)
    # --- sorted event window -------------------------------------------
    pending: np.ndarray           # [M] row indices in (T_sb, seq) order
    ptr: np.ndarray               # next pending position
    n_pending: np.ndarray         # valid pending entries
    # --- clock / counters (0-d int32) ----------------------------------
    now: np.ndarray
    rank_ctr: np.ndarray          # next fifo rank to hand out
    sched_id: np.ndarray          # engine.SCHED_* scheduler code
    alloc_id: np.ndarray          # engine.ALLOC_* allocator code
    n_submitted: np.ndarray
    n_completed: np.ndarray
    n_rejected: np.ndarray
    n_started: np.ndarray
    n_events: np.ndarray
    n_rounds: np.ndarray          # dispatch rounds with a non-empty queue
    steps: np.ndarray             # outer-loop iterations (runaway guard)
    # --- per-event log [E] (feeds the bench/plots pipeline) ------------
    log_t: np.ndarray
    log_queue: np.ndarray
    log_running: np.ndarray
    log_started: np.ndarray
    # --- failure schedule + node health (DESIGN.md §9) ------------------
    # ``fail_ev [F, 3]`` is the sorted (time, node, kind) schedule with
    # kind 1 = FAIL, 0 = REPAIR; ``F = 0`` means "no failure schedule"
    # and selects the engine built without the failure machinery (a
    # template flag).  ``pri`` holds the policy's priority positions,
    # recomputed after each failure drain because requeues re-rank
    # victims mid-run.
    pri: np.ndarray               # [M] static priority positions
    fail_ev: np.ndarray           # [F, 3] (time, node, kind); kind 1=FAIL
    fptr: np.ndarray              # next failure event (0-d)
    n_fail: np.ndarray            # valid failure events (0-d)
    node_up: np.ndarray           # [N] 1 = up, 0 = down
    quar_until: np.ndarray        # [N] dispatch-ineligible until this time
    down_since: np.ndarray        # [N] fail time while down, -1 when up
    quarantine_s: np.ndarray      # 0-d quarantine window after each FAIL
    ckpt_every_s: np.ndarray      # 0-d checkpoint period (0 = no credit)
    n_requeued: np.ndarray        # victims preempted + re-queued
    lost_work_s: np.ndarray       # re-run seconds (net of ckpt credit)
    node_downtime_s: np.ndarray   # summed fail->repair outage seconds
    # --- device-resident telemetry (DESIGN.md §10) ----------------------
    # ``tele_buf [S, 5 + R]`` is the downsampled sample matrix (columns:
    # t, queue, running, started_cum, requeued_cum, free per resource
    # type); ``S = 0`` means "telemetry off" and selects the engine
    # built without telemetry (a template flag, like ``F = 0``).  The
    # stride is data (0-d), so stride sweeps share one build;
    # ``stride = 0`` disables writes, keeping telemetry-off sims inert
    # when padded into a telemetry-on batch.  The per-phase trip
    # counters accumulate one add per event.
    tele_stride: np.ndarray       # 0-d sampling stride (0 = off)
    tele_n: np.ndarray            # 0-d samples written
    tele_buf: np.ndarray          # [S, 5 + R] sample matrix
    ct_disp_trips: np.ndarray     # 0-d greedy allocation probes
    ct_shadow_trips: np.ndarray   # 0-d shadow-walk release iterations
    ct_backfill: np.ndarray       # 0-d backfill admissions
    ct_misfit: np.ndarray         # 0-d backfill candidates not admitted

    # ------------------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return int(self.submit.shape[0])

    @property
    def n_nodes(self) -> int:
        return int(self.avail.shape[0])

    # ------------------------------------------------------------------
    def pad_to(self, m: int, k: int, fev: Optional[int] = None,
               ts: Optional[int] = None) -> "SimState":
        """Grow row capacity to ``m``, the assignment width to ``k``, the
        failure-schedule length to ``fev`` and the telemetry sample
        capacity to ``ts`` (no-op if already that size) — fleet batching
        pads every sim to the common shape before stacking.  Pad rows
        carry the blank defaults (COMPLETED state, INF submit); pad
        failure events carry ``t = INF_I``, which the drain loop never
        reaches; pad telemetry rows stay zero (``tele_n`` never reaches
        them — and a telemetry-off sim padded into a telemetry-on batch
        keeps ``tele_stride = 0``, so it never writes at all)."""
        m0, k0 = self.n_rows, self.assigned.shape[1]
        f0 = self.fail_ev.shape[0]
        s0 = self.tele_buf.shape[0]
        if fev is None:
            fev = f0
        if ts is None:
            ts = s0
        if m < m0 or k < k0 or fev < f0 or ts < s0:
            raise ValueError(
                f"cannot shrink ({m0},{k0},{f0},{s0}) -> "
                f"({m},{k},{fev},{ts})")
        if m == m0 and k == k0 and fev == f0 and ts == s0:
            return self
        n, r = self.avail.shape
        f = self._blank(m, n, r, k, fev, ts)
        e0 = self.log_t.shape[0]
        for name, val in self._asdict().items():
            cur = np.asarray(val)
            if cur.ndim == 0:
                f[name] = cur
            elif name == "req":
                f[name][:m0] = cur
            elif name == "assigned":
                # pad columns keep the old trash id (== n) from _blank
                f[name][:m0, :k0] = cur
            elif name == "fail_ev":
                f[name][:f0] = cur
            elif name == "tele_buf":
                f[name][:s0] = cur
            elif name.startswith("log_"):
                f[name][:e0] = cur
            elif name in ("avail", "capacity", "node_up", "quar_until",
                          "down_since"):
                f[name] = cur
            else:
                f[name][:m0] = cur
        return SimState(**f)

    # ------------------------------------------------------------------
    @classmethod
    def _blank(cls, m: int, n: int, r: int, k: int,
               fev: int = 0, ts: int = 0) -> Dict[str, np.ndarray]:
        e = 2 * m + fev + 8
        i32 = np.int32
        fail_ev = np.zeros((fev, 3), i32)
        fail_ev[:, 0] = INF_I                 # pad events never fire
        return dict(
            submit=np.full(m, INF_I, i32), duration=np.zeros(m, i32),
            est=np.ones(m, i32), n_need=np.zeros(m, i32),
            state=np.full(m, COMPLETED, i32),
            queued_time=np.full(m, UNSET_I, i32),
            start=np.full(m, UNSET_I, i32), end=np.full(m, INF_I, i32),
            fifo_rank=np.full(m, INF_I, i32), unfit=np.zeros(m, i32),
            req=np.zeros((m, r), i32), assigned=np.full((m, k), n, i32),
            avail=np.zeros((n, r), i32), capacity=np.zeros((n, r), i32),
            pending=np.zeros(m, i32), ptr=i32(0), n_pending=i32(0),
            now=i32(0), rank_ctr=i32(0), sched_id=i32(0), alloc_id=i32(0),
            n_submitted=i32(0), n_completed=i32(0), n_rejected=i32(0),
            n_started=i32(0), n_events=i32(0), n_rounds=i32(0),
            steps=i32(0),
            log_t=np.zeros(e, i32), log_queue=np.zeros(e, i32),
            log_running=np.zeros(e, i32), log_started=np.zeros(e, i32),
            pri=np.zeros(m, i32), fail_ev=fail_ev,
            fptr=i32(0), n_fail=i32(0),
            node_up=np.ones(n, i32), quar_until=np.zeros(n, i32),
            down_since=np.full(n, -1, i32),
            quarantine_s=i32(0), ckpt_every_s=i32(0),
            n_requeued=i32(0), lost_work_s=i32(0), node_downtime_s=i32(0),
            tele_stride=i32(0), tele_n=i32(0),
            tele_buf=np.zeros((ts, 5 + r), i32),
            ct_disp_trips=i32(0), ct_shadow_trips=i32(0),
            ct_backfill=i32(0), ct_misfit=i32(0),
        )

    # ------------------------------------------------------------------
    @classmethod
    def from_workload(
        cls,
        workload: Iterable,
        sys_config: Dict,
        job_factory: Optional[JobFactory] = None,
        sched_id: int = 0,
        alloc_id: int = 0,
        k_nodes: Optional[int] = None,
        capacity_rows: Optional[int] = None,
        failures=None,
        quarantine_s: int = 0,
        ckpt_every_s: int = 0,
        telemetry_stride: int = 0,
        telemetry_samples: Optional[int] = None,
    ) -> Tuple["SimState", "SimMeta"]:
        """Load a whole workload into a fresh fixed-capacity state.

        Records (or pre-built ``Job`` objects) stream into a
        :class:`JobTable` in workload order — row index = load sequence —
        then the columns are exported with the pending window sorted by
        ``(T_sb, seq)``, exactly the order the host event manager's
        LOADED heap pops.

        ``failures`` (a ``FailureInjector`` or its ``(times, nodes,
        is_fail)`` arrays) installs the native FAIL/REPAIR schedule with
        the same semantics as ``Simulator(failures=...)``; the export
        below carries it into the device-resident ``fail_ev`` schedule.
        """
        rm = ResourceManager(sys_config)
        factory = job_factory or JobFactory()
        table = JobTable(rm.resource_types)
        rows: List[int] = []
        for item in workload:
            if isinstance(item, Job):
                # copy, don't adopt: the same Job objects feed every grid
                # point of a fleet, so they must stay unbound
                rows.append(table.add(
                    id=item.id, user_id=item.user_id,
                    submission_time=item.submission_time,
                    duration=item.duration,
                    expected_duration=item.expected_duration,
                    requested_nodes=item.requested_nodes,
                    requested_resources=item.requested_resources))
            else:
                rows.append(factory.fill_row(table, item))
        # +1 so _refill drains the source past the last row and flips
        # _exhausted (the window check is len(loaded) < lookahead)
        em = EventManager(iter(rows), rm, table=table,
                          lookahead_jobs=len(rows) + 1)
        if failures is not None:
            arrays = failures.arrays() \
                if hasattr(failures, "arrays") else failures
            ckpt = None
            if ckpt_every_s:
                from ..cluster.failures import CheckpointRestartPolicy
                ckpt = CheckpointRestartPolicy(ckpt_every_s)
            em.set_failure_schedule(*arrays, checkpoint=ckpt,
                                    quarantine_s=quarantine_s)
        return cls.from_event_manager(
            em, sched_id=sched_id, alloc_id=alloc_id, k_nodes=k_nodes,
            capacity_rows=capacity_rows, telemetry_stride=telemetry_stride,
            telemetry_samples=telemetry_samples)

    # ------------------------------------------------------------------
    @classmethod
    def from_event_manager(
        cls,
        em: EventManager,
        sched_id: int = 0,
        alloc_id: int = 0,
        k_nodes: Optional[int] = None,
        capacity_rows: Optional[int] = None,
        telemetry_stride: int = 0,
        telemetry_samples: Optional[int] = None,
    ) -> Tuple["SimState", "SimMeta"]:
        """Snapshot a live (possibly mid-simulation) event manager.

        ``telemetry_stride`` > 0 sizes a device-resident telemetry buffer
        (DESIGN.md §10): one sample row every ``stride`` events plus a
        final end-of-sim row.  ``telemetry_samples`` overrides the
        default capacity ``ceil((2M + 8 + 2F) / stride) + 1``, which
        covers every run except pathological requeue storms (each
        requeue adds one completion event); an overfull buffer stops
        writing and the decoded trace is flagged ``truncated``.

        The workload source must be exhausted — the compiled loop cannot
        pull from a Python iterator, so every future submission has to
        already be a table row (run with ``lookahead_jobs >= n_jobs``, or
        use :meth:`from_workload`).
        """
        if not em._exhausted:
            raise ValueError(
                "workload source not exhausted: the compiled engine needs "
                "every job materialized as a table row (raise "
                "lookahead_jobs or use SimState.from_workload)")
        table, rm = em.table, em.rm
        lim = int(table._next)              # occupied row prefix
        m = max(lim, 1)
        if capacity_rows is not None:
            if capacity_rows < lim:
                raise ValueError(f"capacity_rows={capacity_rows} < "
                                 f"{lim} occupied rows")
            m = max(m, int(capacity_rows))
        n, r = rm.capacity.shape
        live = np.zeros(m, dtype=bool)
        live[:lim] = [table.ids[i] is not None for i in range(lim)]
        if k_nodes is None:
            k_nodes = int(table.requested_nodes[:lim][live[:lim]]
                          .max(initial=1))
        k_nodes = max(int(k_nodes), 1)

        ft = getattr(em, "_fail_t", None)
        nf = 0 if ft is None else int(ft.shape[0])
        stride = max(int(telemetry_stride), 0)
        if stride > 0:
            ts = telemetry_samples if telemetry_samples is not None else \
                -(-(2 * m + 8 + 2 * nf) // stride) + 1
            ts = max(int(ts), 1)
        else:
            ts = 0
        f = cls._blank(m, n, r, k_nodes, nf, ts)
        if stride > 0:
            f["tele_stride"] = np.int32(stride)
        cols = {c: np.zeros(m, dtype=np.int64) for c in _INT_COLS}
        for c in _INT_COLS:
            cols[c][:lim] = getattr(table, c)[:lim]
        hi = int(max(cols["submit"][live].max(initial=0), 0)
                 + max(cols["duration"][live].max(initial=0), 0))
        if nf:
            hi = max(hi, int(ft.max()) + int(em.quarantine_s))
        if hi >= int(INF_I) // 2:
            raise ValueError(f"timestamps too large for int32 engine ({hi})")
        f["submit"][live] = cols["submit"][live]
        f["duration"][live] = cols["duration"][live]
        f["est"][live] = np.maximum(cols["expected_duration"][live], 1)
        f["n_need"][live] = cols["requested_nodes"][live]
        f["state"][live] = cols["state"][live]
        f["queued_time"][live] = cols["queued_time"][live]
        f["start"][live] = cols["start_time"][live]
        end = cols["end_time"][live]
        f["end"][live] = np.where(end == UNSET, INF_I, end)
        f["req"][:lim] = table.req[:lim]
        f["req"][~live] = 0
        for row, idx in table._assigned.items():
            if row < m and live[row]:
                f["assigned"][row, : idx.shape[0]] = idx
        f["avail"] = rm.available.astype(np.int32)
        f["capacity"] = rm.capacity.astype(np.int32)

        live_rows = np.nonzero(live)[0]
        if live_rows.size:
            f["unfit"][live_rows] = 0
            bad = rm.unfit_rows(table, live_rows)
            f["unfit"][bad] = 1

        # pending window: the LOADED heap in (T_sb, seq) pop order
        pend = sorted(em.loaded)
        f["n_pending"] = np.int32(len(pend))
        for p, (_, _, row) in enumerate(pend):
            f["pending"][p] = row
        # masked FIFO queue -> per-row enqueue ranks
        qrows = em.queue_rows()
        for rank, row in enumerate(qrows):
            f["fifo_rank"][int(row)] = rank
        f["rank_ctr"] = np.int32(len(qrows))
        f["now"] = np.int32(em.current_time)
        f["sched_id"] = np.int32(sched_id)
        f["alloc_id"] = np.int32(alloc_id)
        f["n_submitted"] = np.int32(em.n_submitted)
        f["n_completed"] = np.int32(em.n_completed)
        f["n_rejected"] = np.int32(em.n_rejected)

        # failure schedule + node health (no-op fields when nf == 0)
        if nf:
            f["fail_ev"][:, 0] = ft
            f["fail_ev"][:, 1] = em._fail_node
            f["fail_ev"][:, 2] = em._fail_kind.astype(np.int32)
            f["fptr"] = np.int32(em._fcursor)
            f["n_fail"] = np.int32(nf)
            f["node_up"] = em._node_up.astype(np.int32)
            f["quar_until"] = np.minimum(em._quar_until,
                                         int(INF_I)).astype(np.int32)
            f["down_since"] = em._down_since.astype(np.int32)
            f["quarantine_s"] = np.int32(em.quarantine_s)
            f["ckpt_every_s"] = np.int32(
                getattr(em._ckpt, "ckpt_every_s", 0) or 0)
            f["n_requeued"] = np.int32(em.n_requeued)
            f["lost_work_s"] = np.int32(em.lost_work_s)
            f["node_downtime_s"] = np.int32(em.node_downtime_s)

        meta = SimMeta(
            ids=tuple(table.ids[i] if live[i] else None for i in range(m)),
            user=np.where(live, cols["user_id"], -1).astype(np.int64),
            expected=np.where(live, cols["expected_duration"], 0
                              ).astype(np.int64),
            resource_types=tuple(rm.resource_types),
            n_jobs=int(live.sum()), k_nodes=k_nodes)
        return cls(**f), meta


@dataclass(frozen=True)
class SimMeta:
    """Host-side companion of a :class:`SimState`: everything the
    compiled loop never touches but record/trace reconstruction needs."""

    ids: Tuple[Optional[str], ...]
    user: np.ndarray
    expected: np.ndarray          # original walltime estimates (pre-clamp)
    resource_types: Tuple[str, ...]
    n_jobs: int
    k_nodes: int


# ======================================================================
# Host round-trip snapshot
# ======================================================================

@dataclass
class HostSnapshot:
    """Complete array export of a host engine triple (JobTable /
    EventManager / ResourceManager), restorable into live objects.

    Fidelity contract (pinned by ``tests/test_fleet_state.py``): the
    free list (order included), per-row generation stamps, the queue
    ring buffer with its tombstones and head/tail, and both event heaps
    with their sequence numbers survive a take/restore cycle, so a
    restored manager replays the exact event stream of the original.
    """

    # JobTable
    cap: int
    next_row: int
    columns: Dict[str, np.ndarray]
    req: np.ndarray
    gen: np.ndarray
    ids: List[Optional[str]]
    resources: List[Optional[dict]]
    attrs: Dict[int, dict]
    assigned: Dict[int, np.ndarray]
    free: List[int]
    n_added: int
    n_recycled: int
    # EventManager
    current_time: int
    loaded: List[Tuple[int, int, int]]
    completions: List[Tuple[int, int, int]]
    qbuf: np.ndarray
    qlive: np.ndarray
    qhead: int
    qtail: int
    qpos: Dict[int, int]
    running: List[int]
    seq: int
    exhausted: bool
    lookahead: int
    n_submitted: int
    n_completed: int
    n_rejected: int
    # ResourceManager
    resource_types: Tuple[str, ...]
    capacity: np.ndarray
    available: np.ndarray
    node_group: List[str]
    n_live_alloc: int

    # ------------------------------------------------------------------
    @classmethod
    def take(cls, em: EventManager) -> "HostSnapshot":
        table, rm = em.table, em.rm
        cap = table._cap
        return cls(
            cap=cap, next_row=table._next,
            columns={c: getattr(table, c)[:cap].copy() for c in _INT_COLS},
            req=table.req[:cap].copy(), gen=table.gen[:cap].copy(),
            ids=list(table.ids),
            resources=[None if d is None else dict(d)
                       for d in table._resources],
            attrs={r: dict(d) for r, d in table._attrs.items()},
            assigned={r: v.copy() for r, v in table._assigned.items()},
            free=list(table._free), n_added=table.n_added,
            n_recycled=table.n_recycled,
            current_time=em.current_time,
            loaded=list(em.loaded), completions=list(em._completions),
            qbuf=em._qbuf.copy(), qlive=em._qlive.copy(),
            qhead=em._qhead, qtail=em._qtail, qpos=dict(em._qpos),
            running=sorted(em._running), seq=em._seq,
            exhausted=em._exhausted, lookahead=em._lookahead,
            n_submitted=em.n_submitted, n_completed=em.n_completed,
            n_rejected=em.n_rejected,
            resource_types=tuple(rm.resource_types),
            capacity=rm.capacity.copy(), available=rm.available.copy(),
            node_group=list(rm.node_group), n_live_alloc=rm._n_live,
        )

    # ------------------------------------------------------------------
    def restore(self, source: Iterable = (),
                on_complete=None) -> EventManager:
        """Rebuild a live ``EventManager`` (with fresh ``JobTable`` and
        ``ResourceManager``) from this snapshot.

        ``source`` supplies any *not-yet-materialized* workload items
        (the host-fallback contract: a snapshot only carries rows that
        exist — if the original source was not exhausted, the caller
        must re-supply the remainder).
        """
        rm = ResourceManager.__new__(ResourceManager)
        rm.resource_types = list(self.resource_types)
        rm.rt_index = {rt: i for i, rt in enumerate(rm.resource_types)}
        rm.capacity = self.capacity.copy()
        rm.available = self.available.copy()
        rm.node_group = list(self.node_group)
        rm.n_nodes = rm.capacity.shape[0]
        rm._allocations = {}
        rm._n_live = self.n_live_alloc
        rm._group_cache = None

        table = JobTable(self.resource_types, initial_capacity=self.cap)
        for col, arr in self.columns.items():
            getattr(table, col)[: self.cap] = arr
        table.req[: self.cap] = self.req
        table.gen[: self.cap] = self.gen
        table.ids = list(self.ids)
        table._resources = [None if d is None else dict(d)
                            for d in self.resources]
        table._attrs = {r: dict(d) for r, d in self.attrs.items()}
        table._assigned = {r: v.copy() for r, v in self.assigned.items()}
        table._free = list(self.free)
        table._next = self.next_row
        table.n_added = self.n_added
        table.n_recycled = self.n_recycled

        em = EventManager.__new__(EventManager)
        em.rm = rm
        em.table = table
        em._source = iter(source)
        em._lookahead = self.lookahead
        em._on_complete = on_complete
        em.current_time = self.current_time
        em.loaded = list(self.loaded)
        heapq.heapify(em.loaded)
        em._completions = list(self.completions)
        heapq.heapify(em._completions)
        em._qbuf = self.qbuf.copy()
        em._qlive = self.qlive.copy()
        em._qhead = self.qhead
        em._qtail = self.qtail
        em._qpos = dict(self.qpos)
        em._running = set(self.running)
        em._seq = self.seq
        em._exhausted = self.exhausted
        em.n_submitted = self.n_submitted
        em.n_completed = self.n_completed
        em.n_rejected = self.n_rejected
        if not em._exhausted:
            em._refill()
        return em
