"""The port's fleet engine (plain version, on the CPU) against the
reference's compiled engine and the golden host traces.

``FleetRunner(device="cpu")`` runs ``advance_plain`` sim by sim; the
CUDA kernel is held against that plain version on the card
(``tests/test_torch_fleet_kernel.py``, ``chip_smoke.py``).  Here the
eight Table-2 policies on the golden scenario must reproduce
``tests/data/golden_traces.json`` and the reference ``FleetRunner``'s
final states field by field (integers, exact); the prefilter, padding,
cost grouping and a two-device split must not change a decision; a
mid-simulation host snapshot must continue identically; and the plain
``shadow_walk`` must equal the reference's on seeded random cases.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.dispatchers as ref_disp
import repro.fleet as ref_fleet
from repro.core.job import JobFactory as RefJobFactory
from repro.kernels.ebf_shadow import shadow_walk as ref_shadow_walk
from repro.workloads.synthetic import SyntheticWorkload as RefWorkload
from repro_torch.core.dispatchers import (BestFit, EasyBackfilling, FirstFit,
                                          FirstInFirstOut, LongestJobFirst,
                                          ShortestJobFirst)
from repro_torch.core.job import JobFactory
from repro_torch.core.simulator import Simulator
from repro_torch.fleet import (ALLOC_BF, ALLOC_FF, SCHED_EBF, SCHED_FIFO,
                               SCHED_LJF, SCHED_SJF, FleetResult, FleetRunner,
                               FleetSim, SimState, advance, alloc_code,
                               compiles, dispatch_code, sched_code)
from repro_torch.kernels.ebf_shadow import INF_I, shadow_walk
from repro_torch.workloads.synthetic import SyntheticWorkload

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "data",
                           "golden_traces.json")
SYS = {"groups": {"a": {"core": 4, "mem": 1024}, "b": {"core": 8, "mem": 2048}},
       "nodes": {"a": 6, "b": 4}}
TAGS = {"FIFO-FF": (SCHED_FIFO, ALLOC_FF), "FIFO-BF": (SCHED_FIFO, ALLOC_BF),
        "SJF-FF": (SCHED_SJF, ALLOC_FF), "SJF-BF": (SCHED_SJF, ALLOC_BF),
        "LJF-FF": (SCHED_LJF, ALLOC_FF), "LJF-BF": (SCHED_LJF, ALLOC_BF),
        "EBF-FF": (SCHED_EBF, ALLOC_FF), "EBF-BF": (SCHED_EBF, ALLOC_BF)}
WL = dict(mean_interarrival_s=25.0, duration_median_s=900.0,
          duration_sigma=1.1, node_weights={1: 0.5, 2: 0.3, 4: 0.2},
          resources={"core": (1, 4), "mem": (64, 1024)})
CPU = "cpu"


def _sims(n=400, seed=29, tags=sorted(TAGS)):
    return [FleetRunner.build(tag, SyntheticWorkload(n, seed=seed, **WL),
                              SYS, *TAGS[tag], job_factory=JobFactory())
            for tag in tags]


def _ref_sims(n=400, seed=29, tags=sorted(TAGS)):
    return [ref_fleet.FleetRunner.build(tag, RefWorkload(n, seed=seed, **WL),
                                        SYS, *TAGS[tag],
                                        job_factory=RefJobFactory())
            for tag in tags]


def assert_states_equal(got, want, what=""):
    bad = [k for k in SimState._fields
           if not np.array_equal(np.asarray(getattr(got, k)),
                                 np.asarray(getattr(want, k)))]
    assert not bad, f"{what}: fields differ: {bad}"


@pytest.fixture(scope="module")
def fleet():
    """The 8 policies on the golden scenario in one mixed launch, in the
    port (plain version) and in the reference."""
    mine = FleetRunner(device=CPU).run(_sims(), group_by_cost=False)
    theirs = ref_fleet.FleetRunner().run(_ref_sims(), group_by_cost=False)
    return mine, theirs


def test_fleet_traces_match_host_golden(fleet):
    with open(GOLDEN_PATH) as fh:
        golden = json.load(fh)
    mine, _ = fleet
    for i, tag in enumerate(sorted(TAGS)):
        got, want = mine.trace(i), golden[tag]
        assert set(got) == set(want), tag
        diff = [j for j in want if want[j] != got[j]]
        assert not diff, f"{tag}: {len(diff)} jobs diverged"


def test_fleet_final_states_equal_reference(fleet):
    mine, theirs = fleet
    for i, tag in enumerate(sorted(TAGS)):
        assert_states_equal(mine.finals[i], theirs.finals[i], tag)
        a, b = mine.summary(i), theirs.summary(i)
        for key in ("dispatcher", "events", "submitted", "completed",
                    "rejected", "kernel_launches", "sim_end_time", "engine"):
            assert a[key] == b[key], (tag, key)


def test_fleet_outputs_match_reference(fleet, tmp_path):
    mine, theirs = fleet
    out, bench = mine.write_outputs(str(tmp_path / "p"), 7)
    ref_out, ref_bench = theirs.write_outputs(str(tmp_path / "r"), 7)
    with open(out) as a, open(ref_out) as b:
        assert a.read() == b.read()
    rows = [json.loads(x) for x in open(bench)]
    ref_rows = [json.loads(x) for x in open(ref_bench)]
    assert len(rows) == len(ref_rows)
    for x, y in zip(rows[:-1], ref_rows[:-1]):
        assert (x["t"], x["queue"], x["running"]) == \
            (y["t"], y["queue"], y["running"])
    assert mine.records(0) == theirs.records(0)


@pytest.mark.parametrize("tag", ["SJF-FF", "EBF-BF"])
def test_kernel_prefilter_is_decision_identical(fleet, tag):
    """``use_kernel=True`` ANDs the round's fit bits; every decision
    stays the same, including EBF's head reservation, which skips it."""
    mine, theirs = fleet
    i = sorted(TAGS).index(tag)
    res = FleetRunner(use_kernel=True, device=CPU).run(_sims(tags=[tag]))
    ref = ref_fleet.FleetRunner(use_kernel=True).run(_ref_sims(tags=[tag]))
    assert_states_equal(res.finals[0], ref.finals[0], tag)
    assert_states_equal(res.finals[0], mine.finals[i], tag)
    assert res.summary(0)["kernel_launches"] == int(res.finals[0].n_rounds)
    assert mine.summary(i)["kernel_launches"] == 0


def test_cost_grouping_is_decision_identical(fleet):
    mine, _ = fleet
    grouped = FleetRunner(device=CPU).run(_sims())
    assert [l["cost_class"] for l in grouped.launches] == ["blocking", "ebf"]
    assert sum(l["n_sims"] for l in grouped.launches) == len(TAGS)
    for i, tag in enumerate(sorted(TAGS)):
        assert_states_equal(grouped.finals[i], mine.finals[i], tag)


def test_two_device_split_equals_single_launch(fleet):
    mine, _ = fleet
    split = FleetRunner(devices=[CPU, CPU]).run(_sims(),
                                                group_by_cost=False)
    assert split.n_devices == 2
    for i, tag in enumerate(sorted(TAGS)):
        assert_states_equal(split.finals[i], mine.finals[i], tag)


def test_padding_is_inert():
    state, _ = SimState.from_workload(SyntheticWorkload(100, seed=3, **WL),
                                      SYS, job_factory=JobFactory(),
                                      sched_id=SCHED_EBF, alloc_id=ALLOC_BF)
    m, k = state.n_rows, state.assigned.shape[1]
    f1 = advance(state, device=CPU)
    f2 = advance(state.pad_to(m + 23, k + 3), device=CPU)
    for name in ("start", "end", "state", "queued_time", "fifo_rank"):
        assert np.array_equal(np.asarray(getattr(f1, name)),
                              np.asarray(getattr(f2, name))[:m]), name
    assert np.array_equal(f1.assigned, f2.assigned[:m, :k])
    assert np.array_equal(f1.avail, f2.avail)
    assert int(f1.n_events) == int(f2.n_events)
    assert int(f1.now) == int(f2.now)


def test_launch_cache_bookkeeping():
    runner = FleetRunner(device=CPU)
    build = lambda n, seed, sc, ac: FleetRunner.build(
        f"c{n}-{seed}", SyntheticWorkload(n, seed=seed, **WL), SYS, sc,
        alloc_id=ac, job_factory=JobFactory())
    r1 = runner.run([build(101, 3, SCHED_FIFO, ALLOC_FF)])
    r2 = runner.run([build(91, 5, SCHED_EBF, ALLOC_BF)])   # same bucket
    assert r2.cache_hit and r2.compile_time_s == 0.0
    cold = FleetRunner(device=CPU).run([build(91, 5, SCHED_EBF, ALLOC_BF)])
    assert r2.trace(0) == cold.trace(0)
    assert r1.finals[0].submit.shape[0] == 128


def _host_trace(scheduler, tmp_path, n=150, seed=7):
    sim = Simulator(SyntheticWorkload(n, seed=seed, **WL), SYS, scheduler,
                    job_factory=JobFactory(), output_dir=str(tmp_path),
                    name="host")
    out = sim.start_simulation()
    with open(out) as fh:
        return {str(r["id"]): [r["start"], list(r["assigned"]), r["state"]]
                for r in map(json.loads, fh)}


def test_midsim_snapshot_continues_identically(tmp_path):
    """Host runs 40 events, exports a SimState, the fleet engine
    finishes: every job alive at the cut decides as in the pure host
    run, and the final state equals the reference engine's."""
    n, seed = 150, 7

    def cut(sim_cls, wl, sched, fac):
        sim = sim_cls(wl(n, seed=seed, **WL), SYS, sched, job_factory=fac,
                      lookahead_jobs=n + 1, output_dir=str(tmp_path),
                      name="cut")
        sim.start_simulation(max_events=40, write_output=False)
        return sim.event_manager

    from repro.core.simulator import Simulator as RefSimulator
    state, meta = SimState.from_event_manager(
        cut(Simulator, SyntheticWorkload, FirstInFirstOut(FirstFit()),
            JobFactory()), sched_id=SCHED_FIFO)
    ref_state, _ = ref_fleet.SimState.from_event_manager(
        cut(RefSimulator, RefWorkload,
            ref_disp.FirstInFirstOut(ref_disp.FirstFit()), RefJobFactory()),
        sched_id=SCHED_FIFO)
    final = advance(state, device=CPU)
    assert_states_equal(final, ref_fleet.advance(ref_state), "snapshot")
    got = FleetResult(sims=[FleetSim("cut", state, meta, SCHED_FIFO)],
                      finals=[final], wall_time_s=0.0, compile_time_s=0.0,
                      use_kernel=False).trace(0)
    assert got
    want = _host_trace(FirstInFirstOut(FirstFit()), tmp_path, n, seed)
    assert not [j for j in got if want[j] != got[j]]


@pytest.mark.parametrize("sched,tag", [
    (lambda: LongestJobFirst(FirstFit()), "LJF-FF"),
    (lambda: EasyBackfilling(BestFit()), "EBF-BF")])
def test_single_sim_matches_host(sched, tag, tmp_path):
    got = FleetRunner(device=CPU).run(_sims(150, 7, [tag])).trace(0)
    assert got == _host_trace(sched(), tmp_path)


def test_dispatch_code_gating():
    assert dispatch_code(FirstInFirstOut(FirstFit())) == (SCHED_FIFO,
                                                          ALLOC_FF)
    assert dispatch_code(ShortestJobFirst(FirstFit())) == (SCHED_SJF,
                                                           ALLOC_FF)
    assert dispatch_code(LongestJobFirst(BestFit())) == (SCHED_LJF, ALLOC_BF)
    assert dispatch_code(EasyBackfilling(BestFit())) == (SCHED_EBF, ALLOC_BF)
    assert sched_code(EasyBackfilling(BestFit())) == SCHED_EBF
    assert alloc_code(FirstInFirstOut(BestFit())) == ALLOC_BF
    assert compiles(EasyBackfilling(FirstFit()))

    class TweakedFIFO(FirstInFirstOut):
        pass

    class TweakedFF(FirstFit):
        pass

    assert dispatch_code(TweakedFIFO(FirstFit())) is None
    assert dispatch_code(FirstInFirstOut(TweakedFF())) is None
    assert sched_code(TweakedFIFO(FirstFit())) is None
    assert not compiles(TweakedFIFO(FirstFit()))
    from repro_torch.core.dispatchers import WalltimeCorrectedEBF
    assert not compiles(WalltimeCorrectedEBF(FirstFit()))
    # the reference gates the same types
    for s in (ref_disp.FirstInFirstOut(ref_disp.BestFit()),
              ref_disp.EasyBackfilling(ref_disp.FirstFit())):
        assert ref_fleet.dispatch_code(s) == dispatch_code(
            {ref_disp.FirstInFirstOut: FirstInFirstOut,
             ref_disp.EasyBackfilling: EasyBackfilling}[type(s)](
                {ref_disp.BestFit: BestFit,
                 ref_disp.FirstFit: FirstFit}[type(s.allocator)]()))


def _walk_case(rng, n, r, kmax, m=12):
    """Random running rows on n nodes, each on k <= n distinct nodes,
    release times with ties and INF rows, ineligible nodes, a head
    request."""
    assigned = np.full((m, kmax), n, np.int32)
    for i in range(m):
        k = int(rng.integers(1, kmax + 1))
        assigned[i, :k] = rng.choice(n, size=k, replace=False)
    rel = rng.integers(1, 6, m).astype(np.int32)
    rel[rng.random(m) < 0.3] = INF_I
    return (rng.integers(0, 4, (n, r)).astype(np.int32), rel, assigned,
            rng.integers(0, 4, (m, r)).astype(np.int32),
            rng.integers(0, 6, r).astype(np.int32),
            np.int32(rng.integers(1, n + 1)), rng.random(n) < 0.8)


@pytest.mark.parametrize("seed,n,r,kmax", [(0, 1, 1, 1), (1, 2, 1, 2),
                                           (2, 5, 2, 3), (3, 8, 2, 8)])
def test_shadow_walk_matches_reference(seed, n, r, kmax):
    import jax
    ref_walk = jax.jit(ref_shadow_walk)
    rng = np.random.default_rng(seed)
    for _ in range(12):
        avail, rel, assigned, req, head, need, ok = _walk_case(rng, n, r,
                                                               kmax)
        for node_ok in (None, ok):
            found, sh_t, cur = shadow_walk(
                *(torch.from_numpy(x) for x in (avail, rel, assigned, req,
                                                head)), int(need),
                None if node_ok is None else torch.from_numpy(node_ok))
            r_found, r_t, r_cur = ref_walk(
                *(jnp.asarray(x) for x in (avail, rel, assigned, req, head,
                                           need)),
                None if node_ok is None else jnp.asarray(node_ok))
            assert found == bool(r_found)
            assert np.array_equal(cur.numpy(), np.asarray(r_cur))
            if found:
                assert sh_t == int(r_t)
