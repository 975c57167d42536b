"""The ``fleet_engine`` CUDA kernel against its plain PyTorch version.

The kernel runs a whole simulation per thread block; its final
:class:`SimState` must equal ``advance_plain``'s field by field, built in
the reference's order: FIFO/SJF/LJF x FF, then EBF and BF, then failures
(F > 0), then telemetry (S > 0), each with and without the fit-bit
prefilter, and with padded lanes.  The kernel keeps a running-row list
and a rank-ordered queue list across events; the cases that work them
hard: a queue over a thousand deep (the lists fill, compact and run
empty), a host snapshot whose rows are already running and queued when
the kernel starts, failures re-ranking victims behind a long queue, a
host snapshot under failures (victims without a rank, which the
reference orders its own way), and more nodes than threads; then
systems past the kernel's fast paths (2049 to 40,960 nodes, 2048 nodes x
8 types, 9 types), on both tiers of its node arrays, with failures and
telemetry on the global one.  ``tests/test_torch_fleet_deep.py`` and
``tests/test_torch_fleet_wide.py`` hold ``advance_plain`` against the
reference on the same cases.  Imports no JAX, so it runs on a GPU machine
with the port alone::

    python -m pytest -q -m cuda tests/test_torch_fleet_kernel.py

Without a card only the no-fallback checks run.
"""
import numpy as np
import pytest
import torch

from repro_torch.cluster import FailureInjector
from repro_torch.core.dispatchers import (BestFit, EasyBackfilling, FirstFit,
                                          ShortestJobFirst)
from repro_torch.core.job import JobFactory
from repro_torch.core.simulator import Simulator
from repro_torch.fleet import (ALLOC_BF, ALLOC_FF, SCHED_EBF, SCHED_FIFO,
                               SCHED_LJF, SCHED_SJF, FleetRunner, SimState,
                               advance, advance_plain, stack, unstack)
from repro_torch.fleet.state import INF_I, QUEUED, RUNNING
from repro_torch.kernels import build, counters
from repro_torch.workloads.synthetic import SyntheticWorkload

SYS = {"groups": {"a": {"core": 4, "mem": 1024}, "b": {"core": 8, "mem": 2048}},
       "nodes": {"a": 6, "b": 4}}
N_NODES = 10

STEPS = {
    "blocking_ff": [(s, ALLOC_FF) for s in (SCHED_FIFO, SCHED_SJF,
                                            SCHED_LJF)],
    "ebf_bf": [(s, a) for s in (SCHED_FIFO, SCHED_SJF, SCHED_LJF, SCHED_EBF)
               for a in (ALLOC_FF, ALLOC_BF)],
    "failures": [(SCHED_FIFO, ALLOC_FF), (SCHED_SJF, ALLOC_BF),
                 (SCHED_LJF, ALLOC_FF), (SCHED_EBF, ALLOC_FF),
                 (SCHED_EBF, ALLOC_BF)],
    "telemetry": [(SCHED_FIFO, ALLOC_BF), (SCHED_SJF, ALLOC_FF),
                  (SCHED_EBF, ALLOC_FF), (SCHED_EBF, ALLOC_BF)],
}


def _workload(n=150, seed=7):
    return SyntheticWorkload(
        n, seed=seed, mean_interarrival_s=25.0, duration_median_s=900.0,
        duration_sigma=1.1, node_weights={1: 0.5, 2: 0.3, 4: 0.2},
        resources={"core": (1, 4), "mem": (64, 1024)})


def _states(step, n=150):
    kw = {}
    if step in ("failures", "telemetry"):
        kw = dict(failures=FailureInjector(N_NODES, mtbf_s=4000.0,
                                           repair_s=900.0, horizon_s=6000,
                                           seed=3),
                  quarantine_s=300, ckpt_every_s=600)
    if step == "telemetry":
        kw["telemetry_stride"] = 3
    return [FleetRunner.build(f"{sc}-{ac}", _workload(n), SYS, sc,
                              alloc_id=ac, job_factory=JobFactory(),
                              **kw).state
            for sc, ac in STEPS[step]]


def _deep_workload(n, seed=11, mean_interarrival_s=4.0,
                   node_weights=None):
    """Arrivals far faster than the 10 nodes drain them: the queue grows
    past a thousand rows at 1,500 jobs."""
    return SyntheticWorkload(
        n, seed=seed, mean_interarrival_s=mean_interarrival_s,
        duration_median_s=900.0, duration_sigma=1.1,
        node_weights=node_weights or {1: 0.5, 2: 0.3, 4: 0.2},
        resources={"core": (1, 4), "mem": (64, 1024)})


def deep_states(n=1500):
    """EBF-FF and EBF-BF on the deep queue."""
    return [FleetRunner.build(f"deep-{ac}", _deep_workload(n), SYS,
                              SCHED_EBF, alloc_id=ac,
                              job_factory=JobFactory()).state
            for ac in (ALLOC_FF, ALLOC_BF)]


def deep_failure_states(n=600):
    """The deep queue under a failure schedule (checkpoint credit, a
    quarantine): victims are re-ranked behind hundreds of queued rows."""
    inj = FailureInjector(N_NODES, mtbf_s=3000.0, repair_s=600.0,
                          horizon_s=3000, seed=5)
    return [FleetRunner.build(f"deepfail-{sc}-{ac}", _deep_workload(n), SYS,
                              sc, alloc_id=ac, job_factory=JobFactory(),
                              failures=inj, quarantine_s=300,
                              ckpt_every_s=600).state
            for sc, ac in ((SCHED_EBF, ALLOC_BF), (SCHED_SJF, ALLOC_FF))]


def snapshot_states(tmp_dir, n=800, events=300):
    """Host simulators of the deep workload cut after ``events`` events,
    exported mid-run: rows already running and queued (the host's queue
    in rank order, running rows without a rank) when the kernel starts."""
    out = []
    for sched, sc, ac in ((EasyBackfilling(BestFit()), SCHED_EBF, ALLOC_BF),
                          (ShortestJobFirst(FirstFit()), SCHED_SJF,
                           ALLOC_FF)):
        sim = Simulator(_deep_workload(n), SYS, sched, job_factory=JobFactory(),
                        lookahead_jobs=n + 1, output_dir=str(tmp_dir),
                        name="cut")
        sim.start_simulation(max_events=events, write_output=False)
        state, _ = SimState.from_event_manager(sim.event_manager,
                                               sched_id=sc, alloc_id=ac)
        out.append(state)
    return out


def snapshot_failure_states(tmp_dir, n=200, events=60):
    """Host simulators of the deep workload under a failure schedule, cut
    after ``events`` events and exported mid-run: a FAIL evicts running
    rows that carry no rank, so the reference's re-rank leaves rankless
    victims queued (its priority puts them first, its backfill's argmin
    over their INF ranks picks row 0)."""
    out = []
    for sched, sc, ac in ((EasyBackfilling(BestFit()), SCHED_EBF, ALLOC_BF),
                          (ShortestJobFirst(FirstFit()), SCHED_SJF,
                           ALLOC_FF)):
        inj = FailureInjector(N_NODES, mtbf_s=3000.0, repair_s=600.0,
                              horizon_s=3000, seed=5)
        sim = Simulator(_deep_workload(n), SYS, sched, job_factory=JobFactory(),
                        lookahead_jobs=n + 1, output_dir=str(tmp_dir),
                        name="cut", failures=inj, quarantine_s=300)
        sim.start_simulation(max_events=events, write_output=False)
        state, _ = SimState.from_event_manager(sim.event_manager,
                                               sched_id=sc, alloc_id=ac)
        out.append(state)
    return out


WIDE_SYS = {"groups": {"w": {"core": 4, "mem": 1024}}, "nodes": {"w": 600}}


def wide_states(n=400):
    """600 nodes, more than the block's 512 threads, with jobs of up to
    128 nodes: every node loop takes two trips."""
    wl = _deep_workload(n, seed=13, mean_interarrival_s=20.0,
                        node_weights={1: 0.3, 16: 0.3, 64: 0.2, 128: 0.2})
    return [FleetRunner.build(f"wide-{sc}-{ac}", wl, WIDE_SYS, sc,
                              alloc_id=ac, job_factory=JobFactory()).state
            for sc, ac in ((SCHED_EBF, ALLOC_BF), (SCHED_EBF, ALLOC_FF),
                           (SCHED_LJF, ALLOC_BF))]


def large_system(n_nodes, r):
    """Two node groups (3/5 and 2/5 of ``n_nodes``, unequal capacities so
    Best-Fit loads differ) with ``r`` resource types: core, mem, then
    r2, r3, ..."""
    extra = [f"r{i}" for i in range(2, r)]
    a = {"core": 4, "mem": 2048, **{x: 2 + i for i, x in enumerate(extra)}}
    b = {"core": 8, "mem": 4096, **{x: 4 + i for i, x in enumerate(extra)}}
    names = ["core", "mem"][:r] + extra
    na = n_nodes * 3 // 5
    return {"groups": {"a": {k: a[k] for k in names},
                       "b": {k: b[k] for k in names}},
            "nodes": {"a": na, "b": n_nodes - na}}


def large_workload(n_nodes, r, n_jobs, seed=17):
    """Jobs of 1 node to half the system, arriving faster than they end,
    asking at most what a group-a node holds."""
    extra = {f"r{i}": (0, i) for i in range(2, r)}
    res = {"core": (1, 4), "mem": (64, 2048), **extra}
    res = dict(list(res.items())[:r])
    weights = {1: 0.3, max(2, n_nodes // 64): 0.3, max(3, n_nodes // 8): 0.2,
               max(4, n_nodes // 2): 0.2}
    return SyntheticWorkload(
        n_jobs, seed=seed, mean_interarrival_s=20.0,
        duration_median_s=900.0, duration_sigma=1.1, node_weights=weights,
        resources=res)


#: node count, resource types, jobs: past the register keys (2049, 4096,
#: 40,960 nodes), past shared memory (2048 x 8, 40,960), past the
#: unrolled types (R 9, 10)
LARGE = {"n2049": (2049, 2, 60), "n4096": (4096, 2, 80),
         "n40960": (40960, 2, 40), "n2048_r8": (2048, 8, 60),
         "n64_r9": (64, 9, 80), "n64_r10": (64, 10, 80)}
LARGE_POLICIES = [(SCHED_EBF, ALLOC_BF), (SCHED_EBF, ALLOC_FF),
                  (SCHED_FIFO, ALLOC_FF), (SCHED_LJF, ALLOC_BF)]


def large_states(case, policies=LARGE_POLICIES, failures=False):
    """The policies on a ``LARGE`` case's system; with ``failures`` a
    FAIL/REPAIR schedule with checkpoint credit, a quarantine and
    telemetry every 3 events."""
    n_nodes, r, n_jobs = LARGE[case]
    kw = {}
    if failures:
        kw = dict(failures=FailureInjector(n_nodes, mtbf_s=150.0 * n_nodes,
                                           repair_s=900.0, horizon_s=3000,
                                           seed=3),
                  quarantine_s=300, ckpt_every_s=600, telemetry_stride=3)
    return [FleetRunner.build(f"{case}-{sc}-{ac}",
                              large_workload(n_nodes, r, n_jobs),
                              large_system(n_nodes, r), sc, alloc_id=ac,
                              job_factory=JobFactory(), **kw).state
            for sc, ac in policies]


def assert_states_equal(got: SimState, want: SimState, what=""):
    bad = [k for k in SimState._fields
           if not np.array_equal(np.asarray(getattr(got, k)),
                                 np.asarray(getattr(want, k)))]
    assert not bad, f"{what}: fields differ: {bad}"


@pytest.fixture(scope="module")
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("step", list(STEPS))
def test_fleet_kernel_matches_plain(cuda_dev, step, use_kernel):
    states = _states(step)
    counters.reset_device_launches()
    got = unstack(advance(stack(states, cuda_dev), use_kernel))
    assert counters.device_launch_stats() == {"fleet_engine": 1}
    for s, g in zip(states, got):
        want = advance_plain(SimState(*(torch.from_numpy(
            np.asarray(x, dtype=np.int32)) for x in s)), use_kernel)
        assert_states_equal(g, SimState(*(x.numpy() for x in want)), step)
        assert int(g.n_completed) + int(g.n_rejected) == 150


def _equal_to_plain(states, dev, use_kernel, what):
    counters.reset_device_launches()
    got = unstack(advance(stack(states, dev), use_kernel))
    assert counters.device_launch_stats() == {"fleet_engine": 1}
    for s, g in zip(states, got):
        want = advance_plain(SimState(*(torch.from_numpy(
            np.asarray(x, dtype=np.int32)) for x in s)), use_kernel)
        assert_states_equal(g, SimState(*(x.numpy() for x in want)), what)


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel", [False, True])
def test_fleet_kernel_deep_queue(cuda_dev, use_kernel):
    states = deep_states()
    _equal_to_plain(states, cuda_dev, use_kernel, "deep queue")


@pytest.mark.cuda
def test_fleet_kernel_deep_queue_under_failures(cuda_dev):
    _equal_to_plain(deep_failure_states(), cuda_dev, False,
                    "deep queue, failures")


@pytest.mark.cuda
def test_fleet_kernel_midsim_snapshot(cuda_dev, tmp_path):
    states = snapshot_states(tmp_path)
    for s in states:
        assert (s.state == RUNNING).any() and (s.state == QUEUED).sum() > 100
    _equal_to_plain(states, cuda_dev, False, "snapshot")


@pytest.mark.cuda
def test_fleet_kernel_midsim_snapshot_under_failures(cuda_dev, tmp_path):
    states = snapshot_failure_states(tmp_path)
    for s in states:
        running = np.asarray(s.state) == RUNNING
        assert running.any() and int(s.n_fail) > 0
        assert (np.asarray(s.fifo_rank)[running] >= INF_I).all()
    _equal_to_plain(states, cuda_dev, False, "snapshot, failures")


@pytest.mark.cuda
def test_fleet_kernel_more_nodes_than_threads(cuda_dev):
    _equal_to_plain(wide_states(), cuda_dev, True, "600 nodes")


def _tier_bytes(dev, n, r):
    """Dynamic shared memory of a launch at N x R: 0 on the global tier."""
    lib = build.library("fleet_engine")
    return lib.fleet_engine_shared_bytes(n, r, build.device_index(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("case", ["n2049", "n4096", "n40960", "n2048_r8",
                                  "n64_r9"])
def test_fleet_kernel_large_systems(cuda_dev, case, use_kernel):
    """Past the register keys (2049, 4096, 40,960 nodes), past one block's
    shared memory (2048 x 8 and 40,960 nodes: the global tier) and past
    the unrolled types (R 9): EBF-BF, EBF-FF, FIFO-FF and LJF-BF in one
    launch, each equal to its plain run."""
    n, r, _ = LARGE[case]
    global_tier = case in ("n40960", "n2048_r8")
    assert (_tier_bytes(cuda_dev, n, r) == 0) == global_tier
    _equal_to_plain(large_states(case), cuda_dev, use_kernel, case)


@pytest.mark.cuda
def test_fleet_kernel_global_tier_under_failures(cuda_dev):
    """2048 nodes x 8 types on the global tier under a failure schedule
    with checkpoint credit, a quarantine and telemetry."""
    assert _tier_bytes(cuda_dev, 2048, 8) == 0
    states = large_states("n2048_r8", failures=True)
    _equal_to_plain(states, cuda_dev, True, "2048 x 8, failures")


@pytest.mark.cuda
def test_fleet_kernel_padded_lanes(cuda_dev):
    """Lanes padded past their size (rows, width, failure events,
    telemetry samples) in one launch with unpadded-shape twins: the
    padded lane's live prefix equals its solo plain run."""
    base = _states("telemetry", n=90)
    m, k = base[0].n_rows, base[0].assigned.shape[1]
    f, s = base[0].fail_ev.shape[0], base[0].tele_buf.shape[0]
    padded = [st.pad_to(m + 37, k + 5, f + 16, s + 64) for st in base]
    got = unstack(advance(stack(padded, cuda_dev), True))
    for p, g in zip(padded, got):
        want = advance_plain(SimState(*(torch.from_numpy(
            np.asarray(x, dtype=np.int32)) for x in p)), True)
        assert_states_equal(g, SimState(*(x.numpy() for x in want)),
                            "padded")


@pytest.mark.cuda
def test_fleet_runner_defaults_to_the_card(cuda_dev):
    sims = [FleetRunner.build(f"s{i}", _workload(80, 30 + i), SYS, sc,
                              alloc_id=ac, job_factory=JobFactory())
            for i, (sc, ac) in enumerate(STEPS["ebf_bf"])]
    counters.reset_device_launches()
    res = FleetRunner().run(sims)
    assert counters.device_launch_stats()["fleet_engine"] == len(
        res.launches)
    cpu = FleetRunner(device="cpu").run(sims)
    for i in range(len(sims)):
        assert_states_equal(res.finals[i], cpu.finals[i], sims[i].name)


def test_without_gpu_the_fleet_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetRunner()
    state = _states("blocking_ff", n=20)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        advance(state)
