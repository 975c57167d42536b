"""Failure-aware simulation and telemetry across the port's two engines.

The checks of the reference's ``test_failures_engine.py`` and
``test_telemetry.py`` restated against ``repro_torch`` (all but the
``Experiment`` and plot ones, whose layer is not ported yet): a seeded
FAIL/REPAIR schedule (preempt and requeue victims with checkpoint
credit, quarantine-masked dispatch) gives identical dispatch traces,
``failures`` counters and telemetry samples on the host simulator and
on the fleet engine (plain version, on the CPU); the fleet's final
states equal the reference fleet's field by field; telemetry off is
inert.  The host edge cases (requeue, the queue ring, quarantine,
stragglers, the utilization monitor, the trace schema) run on the
port's host core.
"""
import copy

import numpy as np
import pytest

import repro.cluster as ref_cluster
import repro.fleet as ref_fleet
from repro.core.job import JobFactory as RefJobFactory
from repro.experimentation import metrics
from repro.workloads.synthetic import SyntheticWorkload as RefWorkload
from repro_torch.cluster import (FailureInjector, FaultAwareScheduler,
                                 StragglerMonitor)
from repro_torch.cluster.elastic import SlowHostModel
from repro_torch.cluster.failures import CheckpointRestartPolicy
from repro_torch.core import (EventManager, Job, JobState, ResourceManager,
                              Simulator)
from repro_torch.core.dispatchers import (DispatchContext, EasyBackfilling,
                                          FirstFit, FirstInFirstOut)
from repro_torch.core.job import JobFactory
from repro_torch.core.monitors import UtilizationMonitor
from repro_torch.fleet import (ALLOC_BF, ALLOC_FF, SCHED_EBF, SCHED_FIFO,
                               FleetRunner, SimState)
from repro_torch.telemetry import (PHASE_KEYS, TelemetryTrace,
                                   telemetry_columns)
from repro_torch.workloads.synthetic import SyntheticWorkload

SYS = {"groups": {"a": {"core": 4, "mem": 1024}, "b": {"core": 8, "mem": 2048}},
       "nodes": {"a": 6, "b": 4}}
N_NODES = 10
SMALL = {"groups": {"g": {"core": 4}}, "nodes": {"g": 4}}
STRIDE = 5
WL = dict(mean_interarrival_s=25.0, duration_median_s=900.0,
          duration_sigma=1.1, node_weights={1: 0.5, 2: 0.3, 4: 0.2},
          resources={"core": (1, 4), "mem": (64, 1024)})
CPU = "cpu"
SCHEDS = {"FIFO-FF": (lambda: FirstInFirstOut(FirstFit()), SCHED_FIFO,
                      ALLOC_FF),
          "EBF-FF": (lambda: EasyBackfilling(FirstFit()), SCHED_EBF,
                     ALLOC_FF)}


def _injector(cls=FailureInjector, seed=3):
    return cls(N_NODES, mtbf_s=4000.0, repair_s=900.0, horizon_s=6000,
               seed=seed)


def _host_run(tag, tmp_path, n=150, seed=7, stride=0):
    sim = Simulator(SyntheticWorkload(n, seed=seed, **WL), SYS,
                    SCHEDS[tag][0](), job_factory=JobFactory(),
                    output_dir=str(tmp_path), name=f"host-{tag}",
                    failures=_injector(),
                    checkpoint=CheckpointRestartPolicy(600),
                    quarantine_s=1800, telemetry_stride=stride)
    out = sim.start_simulation()
    trace = {}
    import json
    with open(out) as fh:
        for r in map(json.loads, fh):
            trace[str(r["id"])] = [r["start"], list(r["assigned"]),
                                   r["state"]]
    return trace, sim.summary, sim.telemetry


def _fleet_sims(n=150, seed=7, stride=0):
    return [FleetRunner.build(
        tag, SyntheticWorkload(n, seed=seed, **WL), SYS, sc, alloc_id=ac,
        job_factory=JobFactory(), failures=_injector(), quarantine_s=1800,
        ckpt_every_s=600, telemetry_stride=stride)
        for tag, (_, sc, ac) in SCHEDS.items()]


@pytest.fixture(scope="module")
def fleet():
    """FIFO-FF and EBF-FF under failures with telemetry on, in the
    port's fleet (plain version) and in the reference fleet."""
    mine = FleetRunner(device=CPU).run(_fleet_sims(stride=STRIDE))
    theirs = ref_fleet.FleetRunner().run([ref_fleet.FleetRunner.build(
        tag, RefWorkload(150, seed=7, **WL), SYS, sc, alloc_id=ac,
        job_factory=RefJobFactory(),
        failures=_injector(ref_cluster.FailureInjector), quarantine_s=1800,
        ckpt_every_s=600, telemetry_stride=STRIDE)
        for tag, (_, sc, ac) in SCHEDS.items()])
    return mine, theirs


# ----------------------------------------------------------------------
# host failure semantics + host/fleet equality
# ----------------------------------------------------------------------
def test_host_failures_requeue_and_account(tmp_path):
    _, summary, _ = _host_run("FIFO-FF", tmp_path)
    assert summary["submitted"] == 150
    assert summary["completed"] + summary["rejected"] == 150
    f = summary["failures"]
    assert f["requeued_jobs"] > 0
    assert f["lost_work_s"] >= 0
    assert f["node_downtime_s"] > 0


@pytest.mark.parametrize("i,tag", enumerate(SCHEDS))
def test_fleet_matches_host_under_failures(fleet, i, tag, tmp_path):
    """Same seeded failure schedule: identical dispatch traces, failure
    counters and telemetry samples on both engines."""
    want, host_summary, host_tele = _host_run(tag, tmp_path, stride=STRIDE)
    mine, _ = fleet
    got = mine.trace(i)
    assert set(got) == set(want)
    assert not [j for j in want if want[j] != got[j]]
    assert host_summary["failures"]["requeued_jobs"] > 0
    assert dict(mine.summary(i)["failures"]) == \
        dict(host_summary["failures"])
    fleet_tele = mine.telemetry(i)
    host_tele.assert_parity(fleet_tele)
    assert fleet_tele.phase_counters["fail_drain_trips"] > 0
    assert int(fleet_tele.column("requeued_cum")[-1]) > 0
    assert host_summary["telemetry"]["phase_counters"] == \
        mine.summary(i)["telemetry"]["phase_counters"]


def test_fleet_final_states_equal_reference_under_failures(fleet):
    mine, theirs = fleet
    for i in range(len(SCHEDS)):
        for k in SimState._fields:
            assert np.array_equal(np.asarray(getattr(mine.finals[i], k)),
                                  np.asarray(getattr(theirs.finals[i], k))), k
        assert mine.summary(i)["failures"] == theirs.summary(i)["failures"]
        assert mine.telemetry(i).phase_counters == \
            theirs.telemetry(i).phase_counters


def test_failure_lane_padding_is_inert(fleet):
    """A failure-bearing lane next to a failure-free one (whose schedule
    pads with INF rows) decides as when launched alone."""
    mine, _ = fleet
    clean = lambda: FleetRunner.build(
        "clean", SyntheticWorkload(150, seed=3, **WL), SYS, SCHED_FIFO,
        alloc_id=ALLOC_BF, job_factory=JobFactory())
    mixed = FleetRunner(device=CPU).run(
        [_fleet_sims(stride=STRIDE)[0], clean()], group_by_cost=False)
    solo = FleetRunner(device=CPU).run([clean()])
    assert mixed.trace(0) == mine.trace(0)
    assert mixed.trace(1) == solo.trace(0)
    assert "failures" not in mixed.summary(1)


# ----------------------------------------------------------------------
# telemetry on the fleet
# ----------------------------------------------------------------------
def test_telemetry_parity_without_failures(tmp_path):
    sim = Simulator(SyntheticWorkload(120, seed=11, **WL), SYS,
                    EasyBackfilling(FirstFit()), job_factory=JobFactory(),
                    output_dir=str(tmp_path), name="ebf",
                    telemetry_stride=STRIDE)
    sim.start_simulation(write_output=False)
    res = FleetRunner(device=CPU).run([FleetRunner.build(
        "ebf", SyntheticWorkload(120, seed=11, **WL), SYS, SCHED_EBF,
        alloc_id=ALLOC_FF, job_factory=JobFactory(),
        telemetry_stride=STRIDE)])
    fleet_tele = res.telemetry(0)
    sim.telemetry.assert_parity(fleet_tele)
    assert sim.telemetry.capacity == fleet_tele.capacity
    assert fleet_tele.phase_counters["shadow_trips"] > 0
    assert fleet_tele.phase_counters["backfill_admits"] > 0


def test_telemetry_off_is_absent_and_inert():
    build = lambda stride, name: FleetRunner.build(
        name, SyntheticWorkload(120, seed=11, **WL), SYS, SCHED_FIFO,
        alloc_id=ALLOC_FF, job_factory=JobFactory(), telemetry_stride=stride)
    off = FleetRunner(device=CPU).run([build(0, "off")])
    assert off.sims[0].state.tele_buf.shape[0] == 0
    assert off.telemetry(0) is None
    assert "telemetry" not in off.summary(0)
    on = FleetRunner(device=CPU).run([build(STRIDE, "on")])
    assert on.trace(0) == off.trace(0)
    mixed = FleetRunner(device=CPU).run([build(STRIDE, "on"),
                                         build(0, "off")])
    assert int(mixed.finals[1].tele_n) == 0
    assert mixed.telemetry(1) is None
    assert mixed.trace(1) == off.trace(0)


def test_tiny_capacity_flags_truncation():
    res = FleetRunner(device=CPU).run([FleetRunner.build(
        "tiny", SyntheticWorkload(120, seed=11, **WL), SYS, SCHED_FIFO,
        alloc_id=ALLOC_FF, job_factory=JobFactory(), telemetry_stride=1,
        telemetry_samples=4)])
    t = res.telemetry(0)
    assert t.n_samples == 64          # capacity bucketed to one row block
    assert t.truncated


# ----------------------------------------------------------------------
# host edge cases
# ----------------------------------------------------------------------
def _job(jid, submit, duration, cores=4, nodes=1, expected=None):
    return Job(id=jid, user_id=0, submission_time=submit, duration=duration,
               expected_duration=duration if expected is None else expected,
               requested_nodes=nodes, requested_resources={"core": cores})


def test_requeue_releases_resources_exactly_once():
    rm = ResourceManager(SMALL)
    a = _job("a", 0, 100, cores=4, nodes=2)
    em = EventManager(iter([a]), rm)
    em.advance_to(0)
    em.start_job(a, [0, 1])
    em.advance_to(10)
    em.requeue_job(a)
    assert np.all(rm.available == rm.capacity)
    assert a.state == JobState.QUEUED
    assert a.start_time is None and a.end_time is None
    assert list(em.queue_rows()) == [a._row]
    with pytest.raises(ValueError):
        em.requeue_job(a)
    em.start_job(a, [2, 3])                # restart at t=10 -> ends 110
    completed, _ = em.advance_to(100)      # the old end is dead
    assert completed == []
    completed, _ = em.advance_to(110)
    assert len(completed) == 1 and em.n_completed == 1
    assert np.all(rm.available == rm.capacity)


def test_requeue_survives_queue_ring_wrap():
    rm = ResourceManager({"groups": {"g": {"core": 1}}, "nodes": {"g": 1}})
    jobs = [_job(str(i), 0, 50, cores=1, nodes=1) for i in range(3)]
    em = EventManager(iter(jobs), rm)
    em._qbuf = np.empty(4, dtype=np.int64)       # shrink the ring
    em._qlive = np.zeros(4, dtype=bool)
    em.advance_to(0)
    expected = [str(i) for i in range(3)]
    for _ in range(12):
        rows = em.queue_rows()
        assert [em.table.ids[int(r)] for r in rows] == expected
        for row, pos in em._qpos.items():
            assert int(em._qbuf[pos]) == row and bool(em._qlive[pos])
        head = int(rows[0])
        em.start_row(head, [0])
        em.requeue_job(em.table.view(head))
        expected = expected[1:] + [expected[0]]
    assert np.all(rm.available == rm.capacity)


def test_fault_aware_quarantine_expiry_and_reset():
    rm = ResourceManager({"groups": {"g": {"core": 4}}, "nodes": {"g": 2}})
    a = _job("a", 0, 10, cores=4, nodes=1)
    em = EventManager(iter([a]), rm)
    em.advance_to(0)
    sched = FaultAwareScheduler(FirstInFirstOut(FirstFit()),
                                quarantine_s=100)
    sched.note_failure(0, 0)
    sched.note_failure(0, 1)
    assert sorted(sched.quarantined(0)) == [0, 1]
    assert sched.plan(DispatchContext.from_event_manager(0, em)).n_started \
        == 0
    em.advance_to(150)
    assert sched.quarantined(150) == []
    assert sched.plan(DispatchContext.from_event_manager(150, em)
                      ).n_started == 1
    sched.note_failure(155, 0)
    rep = copy.deepcopy(sched)
    rep.reset()
    assert rep.quarantined(156) == []
    assert sched.quarantined(156) == [0]


def test_straggler_monitor_on_recycled_rows_and_restarts():
    rm = ResourceManager({"groups": {"g": {"core": 4}}, "nodes": {"g": 2}})
    mon = StragglerMonitor(slow_threshold=1.2, min_samples=1)
    seen = []

    def hook(job):
        mon.observe(job)
        seen.append(job)

    slow = _job("slow", 0, 150, cores=4, nodes=1, expected=100)
    ok = _job("ok", 0, 100, cores=4, nodes=1, expected=100)
    em = EventManager(iter([slow, ok]), rm, on_complete=hook)
    em.advance_to(0)
    em.start_job(slow, [0])
    em.start_job(ok, [1])
    em.advance_to(200)
    assert len(seen) == 2 and all(not j.bound for j in seen)
    for j in seen:
        mon.observe(j)
        assert j.assigned_nodes
    assert mon.stragglers() == [0]
    mon2 = StragglerMonitor(min_samples=1)
    r = _job("r", 0, 100)
    r.start_time, r.end_time = 0, 100
    r.assigned_nodes = [2]
    r.attrs["restarts"] = 1
    mon2.observe(r)
    assert not mon2.host_ratio
    model = SlowHostModel({3: 1.5})
    s = _job("s", 0, 100)
    s.assigned_nodes = [3]
    assert model.effective_duration(s) == 150
    assert model.effective_duration(s, [7]) == 100


class _StubRM:
    def __init__(self, rts, free):
        self.resource_types = tuple(rts)
        self.available = np.asarray([free], dtype=np.int64)

    def utilization(self):
        return {rt: 0.5 for rt in self.resource_types}


class _StubEM:
    def __init__(self, t, rts=("core",), free=(4,)):
        self.current_time = t
        self.n_queued = self.n_running = self.n_completed = 0
        self.n_requeued = 0
        self.rm = _StubRM(rts, free)


def test_monitor_samples_first_event_and_finalizes():
    mon = UtilizationMonitor(sample_every=4)
    for i in range(6):
        mon.observe(_StubEM(t=10 * i))
    assert mon.times == [0, 40]
    mon.finalize(_StubEM(t=50))
    assert mon.times == [0, 40, 50]
    mon2 = UtilizationMonitor(sample_every=4)
    for i in range(5):
        mon2.observe(_StubEM(t=10 * i))
    mon2.finalize(_StubEM(t=40))
    assert mon2.times == [0, 40]
    mon3 = UtilizationMonitor(sample_every=4)
    mon3.finalize(_StubEM(t=0))
    assert mon3.times == []
    mon4 = UtilizationMonitor()
    mon4.observe(_StubEM(t=0))
    mon4.observe(_StubEM(t=10, rts=("core", "gpu"), free=(4, 2)))
    assert mon4.as_dict()["utilization"]["gpu"] == [0.0, 0.5]
    trace = mon4.to_trace("mid", ("core", "gpu"), {"core": 4, "gpu": 2})
    assert trace.free("gpu").tolist() == [0, 2]


def test_trace_jsonl_round_trip_and_schema(fleet, tmp_path):
    mine, _ = fleet
    path = mine.write_telemetry(str(tmp_path), 0)
    back = TelemetryTrace.read_jsonl(path)
    mine.telemetry(0).assert_parity(back)
    assert back.engine == "fleet" and not back.truncated
    series = metrics.telemetry_series(path)
    assert series["t"] == mine.telemetry(0).times.tolist()
    cols = telemetry_columns(("core", "mem"))
    assert cols[:5] == ("t", "queue", "running", "started_cum",
                        "requeued_cum")
    assert cols[5:] == ("free_core", "free_mem")
    with pytest.raises(ValueError):
        TelemetryTrace(engine="host", name="bad", stride=1,
                       resource_types=("core",),
                       samples=np.zeros((3, 9), dtype=np.int64))
    t = TelemetryTrace(engine="host", name="ok", stride=1,
                       resource_types=("core",),
                       samples=np.zeros((0, 6), dtype=np.int64),
                       phase_counters={"dispatch_trips": 3})
    assert set(t.phase_counters) == set(PHASE_KEYS)
