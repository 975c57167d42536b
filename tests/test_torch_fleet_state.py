"""The port's ``SimState`` / ``HostSnapshot`` against the reference's.

The same seeded workloads go through both packages: ``from_workload``
and ``from_event_manager`` (fresh, mid-simulation, with a failure
schedule and telemetry) must export equal arrays, ``pad_to`` must pad
alike, and a ``HostSnapshot`` taken at the same cut must hold equal
fields and replay the same remaining event stream after ``restore``.
"""
import numpy as np
import pytest

import repro.cluster as ref_cluster
import repro.core.dispatchers as ref_disp
import repro.fleet as ref_fleet
from repro.core.job import JobFactory as RefJobFactory
from repro.core.simulator import Simulator as RefSimulator
from repro.workloads.synthetic import SyntheticWorkload as RefWorkload
from repro_torch.cluster import FailureInjector
from repro_torch.core.dispatchers import FirstFit, FirstInFirstOut
from repro_torch.core.dispatchers.base import Dispatcher
from repro_torch.core.dispatchers.context import DispatchContext
from repro_torch.core.events import EventManager
from repro_torch.core.job import JobFactory
from repro_torch.core.jobtable import JobTable
from repro_torch.core.resources import ResourceManager
from repro_torch.core.simulator import Simulator
from repro_torch.fleet import HostSnapshot, SimState
from repro_torch.fleet.state import COMPLETED, INF_I, QUEUED, RUNNING
from repro_torch.workloads.synthetic import SyntheticWorkload

SYS = {"groups": {"a": {"core": 4, "mem": 1024}, "b": {"core": 8, "mem": 2048}},
       "nodes": {"a": 3, "b": 2}}
WL = dict(mean_interarrival_s=20.0, duration_median_s=700.0,
          duration_sigma=1.1, node_weights={1: 0.5, 2: 0.3, 4: 0.2},
          resources={"core": (1, 4), "mem": (64, 1024)})


def _paused(seed, cut, tmp_path, ref=False, n=120):
    cls, wl, sched, fac = (
        (RefSimulator, RefWorkload,
         ref_disp.FirstInFirstOut(ref_disp.FirstFit()), RefJobFactory())
        if ref else
        (Simulator, SyntheticWorkload, FirstInFirstOut(FirstFit()),
         JobFactory()))
    sim = cls(wl(n, seed=seed, **WL), SYS, sched, job_factory=fac,
              lookahead_jobs=10_000, output_dir=str(tmp_path),
              name=f"pause{seed}{'r' if ref else 'p'}")
    sim.start_simulation(max_events=cut, write_output=False)
    return sim.event_manager


def assert_same_state(mine, theirs):
    assert mine._fields == theirs._fields
    for name in mine._fields:
        a, b = np.asarray(getattr(mine, name)), np.asarray(getattr(theirs, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


def assert_same_meta(mine, theirs):
    assert mine.ids == theirs.ids
    assert np.array_equal(mine.user, theirs.user)
    assert np.array_equal(mine.expected, theirs.expected)
    assert (mine.resource_types, mine.n_jobs, mine.k_nodes) == \
        (theirs.resource_types, theirs.n_jobs, theirs.k_nodes)


@pytest.mark.parametrize("kw", [
    {}, {"sched_id": 3, "alloc_id": 1, "capacity_rows": 100},
    {"failures": True, "quarantine_s": 300, "ckpt_every_s": 600,
     "telemetry_stride": 4}])
def test_from_workload_equals_reference(kw):
    kw = dict(kw)
    ref_kw = dict(kw)
    if kw.pop("failures", None):
        kw["failures"] = FailureInjector(5, 3000.0, 600.0, 5000, seed=2)
        ref_kw["failures"] = ref_cluster.FailureInjector(5, 3000.0, 600.0,
                                                         5000, seed=2)
    state, meta = SimState.from_workload(
        SyntheticWorkload(60, seed=7, **WL), SYS, job_factory=JobFactory(),
        **kw)
    ref_state, ref_meta = ref_fleet.SimState.from_workload(
        RefWorkload(60, seed=7, **WL), SYS, job_factory=RefJobFactory(),
        **ref_kw)
    assert_same_state(state, ref_state)
    assert_same_meta(meta, ref_meta)
    n_pend = int(state.n_pending)
    rows = np.asarray(state.pending)[:n_pend]
    subs = np.asarray(state.submit)[rows]
    assert n_pend == meta.n_jobs == 60 and (np.diff(subs) >= 0).all()


@pytest.mark.parametrize("seed,cut", [(3, 40), (11, 70)])
def test_from_event_manager_midsim_equals_reference(seed, cut, tmp_path):
    em = _paused(seed, cut, tmp_path)
    state, meta = SimState.from_event_manager(em, sched_id=1,
                                              telemetry_stride=5)
    ref_state, ref_meta = ref_fleet.SimState.from_event_manager(
        _paused(seed, cut, tmp_path, ref=True), sched_id=1,
        telemetry_stride=5)
    assert_same_state(state, ref_state)
    assert_same_meta(meta, ref_meta)
    st = np.asarray(state.state)
    assert int((st == QUEUED).sum()) == em.n_queued
    assert int((st == RUNNING).sum()) == em.n_running


def test_from_event_manager_requires_exhausted_source():
    rm = ResourceManager(SYS)
    table = JobTable(rm.resource_types)
    fac = JobFactory()
    rows = [fac.fill_row(table, rec)
            for rec in SyntheticWorkload(30, seed=7, **WL)]
    em = EventManager(iter(rows), rm, table=table, lookahead_jobs=8)
    with pytest.raises(ValueError, match="not exhausted"):
        SimState.from_event_manager(em)


def test_pad_to_equals_reference_and_refuses_shrink():
    state, _ = SimState.from_workload(SyntheticWorkload(30, seed=7, **WL),
                                      SYS, job_factory=JobFactory(),
                                      telemetry_stride=2)
    ref_state, _ = ref_fleet.SimState.from_workload(
        RefWorkload(30, seed=7, **WL), SYS, job_factory=RefJobFactory(),
        telemetry_stride=2)
    m, k = state.n_rows, state.assigned.shape[1]
    big = state.pad_to(m + 13, k + 2, 16, 64)
    assert_same_state(big, ref_state.pad_to(m + 13, k + 2, 16, 64))
    assert (np.asarray(big.submit)[m:] == INF_I).all()
    assert (np.asarray(big.state)[m:] == COMPLETED).all()
    assert (np.asarray(big.assigned)[m:] == state.n_nodes).all()
    assert (np.asarray(big.fail_ev)[:, 0] == INF_I).all()
    with pytest.raises(ValueError):
        big.pad_to(m, k)


def _drive(em):
    """Minimal FIFO-FF host loop to completion; the dispatch trace."""
    dispatcher = Dispatcher(FirstInFirstOut(FirstFit()))
    trace = []
    while em.has_events():
        t = em.next_event_time()
        if t is None:
            for row in em.queue_rows():
                em.reject_row(int(row))
            break
        _, submitted = em.advance_to(t)
        if len(submitted):
            for row in em.rm.unfit_rows(em.table, submitted):
                em.reject_row(int(row))
        if em.n_queued:
            plan = dispatcher.plan(DispatchContext.from_event_manager(t, em))
            for job, nodes in plan.starts:
                trace.append((t, job.id, tuple(int(x) for x in nodes)))
                em.start_job(job, nodes)
            for job in plan.rejects:
                em.reject_job(job)
    return trace


@pytest.mark.parametrize("seed,cut", [(3, 25), (29, 95)])
def test_snapshot_equals_reference_and_replays(seed, cut, tmp_path):
    em = _paused(seed, cut, tmp_path)
    snap = HostSnapshot.take(em)
    ref_snap = ref_fleet.HostSnapshot.take(_paused(seed, cut, tmp_path,
                                                   ref=True))
    for name, val in vars(snap).items():
        want = getattr(ref_snap, name)
        if name in ("qbuf", "qlive"):       # past the tail: never written
            val, want = val[:snap.qtail], want[:ref_snap.qtail]
        if isinstance(val, dict) and name == "columns":
            assert val.keys() == want.keys()
            for c in val:
                assert np.array_equal(val[c], want[c]), c
        elif isinstance(val, dict):
            assert val.keys() == want.keys(), name
            for kk in val:
                assert np.array_equal(np.asarray(val[kk]),
                                      np.asarray(want[kk])), name
        elif isinstance(val, np.ndarray):
            assert np.array_equal(val, want), name
        else:
            assert val == want, name
    em2 = snap.restore()
    assert em2.table._free == em.table._free
    assert np.array_equal(em2.queue_rows(), em.queue_rows())
    trace1, trace2 = _drive(em), _drive(em2)
    assert trace1 == trace2
    assert (em.current_time, em.n_completed, em.n_rejected) == \
        (em2.current_time, em2.n_completed, em2.n_rejected)
