"""Dispatchers of the PyTorch/CUDA port against the JAX reference.

* The port's 8 numpy Table-2 rows reproduce ``data/golden_traces.json``
  (the scenario of ``test_trace_golden.py``).
* The port's 8 vectorized rows ({FIFO,SJF,LJF} x {vFF,vBF} and vEBF x
  {vFF,vBF}, run on the CPU through the kernels' plain versions) give
  the traces of the reference's vectorized rows and of the numpy twins.
* Kernel launches per event match the reference's contract
  (``test_dispatch_api.py``): 1 for the batched blocking policies, at
  most 3 and independent of J for vEBF, started + 1 per-job.
* Per-event replay: every ``DispatchContext`` of a reference vEBF-vBF
  run (with node failures, so floored rows and filtered releases
  occur), rebuilt through ``context_from_arrays``, plans the same.
"""
import json
import os
import random

import numpy as np
import pytest
import torch

from repro.cluster import FailureInjector
from repro.core import EventManager as REventManager
from repro.core import Job as RJob
from repro.core import ResourceManager as RResourceManager
from repro.core import Simulator as RSimulator
from repro.core.dispatchers import BestFit as RBestFit
from repro.core.dispatchers import DispatchContext as RDispatchContext
from repro.core.dispatchers import (FirstInFirstOut as RFirstInFirstOut,
                                    LongestJobFirst as RLongestJobFirst,
                                    ShortestJobFirst as RShortestJobFirst)
from repro.core.dispatchers.base import SchedulerBase as RSchedulerBase
from repro.core.dispatchers.base import Dispatcher as RDispatcher
from repro.core.dispatchers.vectorized import (
    VectorizedAllocator as RVectorizedAllocator,
    VectorizedEasyBackfilling as RVectorizedEasyBackfilling)
from repro.core.job import JobFactory as RJobFactory
from repro.workloads.synthetic import SyntheticWorkload as RSyntheticWorkload

from repro_torch.core import EventManager, Job, ResourceManager, Simulator
from repro_torch.core.dispatchers import (BestFit, DispatchContext,
                                          Dispatcher, EasyBackfilling,
                                          FirstFit, FirstInFirstOut,
                                          LongestJobFirst, ShortestJobFirst,
                                          context_from_arrays)
from repro_torch.core.job import JobFactory
from repro_torch.core.dispatchers.vectorized import (
    VectorizedAllocator, VectorizedEasyBackfilling)
from repro_torch.workloads.synthetic import SyntheticWorkload

# the scenario of test_trace_golden.py
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "data",
                           "golden_traces.json")
SYS = {"groups": {"a": {"core": 4, "mem": 1024}, "b": {"core": 8, "mem": 2048}},
       "nodes": {"a": 6, "b": 4}}
CPU = "cpu"
WL = dict(seed=29, mean_interarrival_s=25.0, duration_median_s=900.0,
          duration_sigma=1.1, node_weights={1: 0.5, 2: 0.3, 4: 0.2},
          resources={"core": (1, 4), "mem": (64, 1024)})
N_JOBS = 400

PORT_SCHED = {"FIFO": FirstInFirstOut, "SJF": ShortestJobFirst,
              "LJF": LongestJobFirst, "EBF": EasyBackfilling}
REF_SCHED = {"FIFO": RFirstInFirstOut, "SJF": RShortestJobFirst,
             "LJF": RLongestJobFirst}


def _run(sim):
    out = sim.start_simulation()
    trace = {}
    with open(out) as fh:
        for line in fh:
            r = json.loads(line)
            trace[str(r["id"])] = [r["start"], list(r["assigned"]),
                                   r["state"]]
    return trace, sim.summary


def _port_trace(sched, tmp_path, tag):
    return _run(Simulator(SyntheticWorkload(N_JOBS, **WL), SYS, sched,
                          job_factory=JobFactory(), output_dir=str(tmp_path),
                          name=tag))


def _ref_trace(sched, tmp_path, tag):
    return _run(RSimulator(RSyntheticWorkload(N_JOBS, **WL), SYS, sched,
                           job_factory=RJobFactory(),
                           output_dir=str(tmp_path), name=tag))


# ---------------------------------------------------------------- golden
@pytest.mark.parametrize("tag", ["FIFO-FF", "SJF-FF", "LJF-FF", "EBF-FF",
                                 "FIFO-BF", "SJF-BF", "LJF-BF", "EBF-BF"])
def test_numpy_rows_match_golden(tag, tmp_path):
    with open(GOLDEN_PATH) as fh:
        want = json.load(fh)[tag]
    sched, alloc = tag.split("-")
    got, _ = _port_trace(
        PORT_SCHED[sched](FirstFit() if alloc == "FF" else BestFit()),
        tmp_path, tag)
    assert got == want


# ---------------------------------------------------------------- vectorized
@pytest.mark.parametrize("sched", ["FIFO", "SJF", "LJF", "EBF"])
@pytest.mark.parametrize("policy", ["FF", "BF"])
def test_vectorized_rows_match_reference_and_numpy(sched, policy, tmp_path):
    alloc = VectorizedAllocator(policy, device=CPU)
    if sched == "EBF":
        port = VectorizedEasyBackfilling(alloc)
        ref = RVectorizedEasyBackfilling(RVectorizedAllocator(policy))
    else:
        port = PORT_SCHED[sched](alloc)
        ref = REF_SCHED[sched](RVectorizedAllocator(policy))
    twin = PORT_SCHED[sched](FirstFit() if policy == "FF" else BestFit())
    got, got_sum = _port_trace(port, tmp_path, f"port-v{sched}-{policy}")
    want, want_sum = _ref_trace(ref, tmp_path, f"ref-v{sched}-{policy}")
    np_trace, _ = _port_trace(twin, tmp_path, f"port-{sched}-{policy}")
    assert got == want == np_trace
    for k in ("events", "kernel_launches", "kernel_launches_per_event"):
        assert got_sum[k] == want_sum[k], k
    if sched != "EBF":
        assert got_sum["kernel_launches_per_event"] == 1.0
    else:
        assert 1.0 < got_sum["kernel_launches_per_event"] <= 3.0


# ---------------------------------------------------------------- launches
def _burst_jobs(cls, n, seed):
    rng = random.Random(seed)
    return [cls(id=str(i), user_id=1, submission_time=0,
                duration=rng.randint(5, 400),
                expected_duration=rng.randint(5, 500),
                requested_nodes=rng.randint(1, 4),
                requested_resources={"core": rng.randint(1, 4),
                                     "mem": rng.randint(64, 900)})
            for i in range(n)]


def _contexts(j, seed):
    """The same burst event as a port context and a reference context."""
    rm = ResourceManager(SYS)
    em = EventManager(iter(_burst_jobs(Job, j, seed)), rm)
    em.advance_to(0)
    rrm = RResourceManager(SYS)
    rem = REventManager(iter(_burst_jobs(RJob, j, seed)), rrm)
    rem.advance_to(0)
    return (DispatchContext.from_event_manager(0, em),
            RDispatchContext.from_event_manager(0, rem))


@pytest.mark.parametrize("j", [32, 64, 128])
def test_batched_path_is_one_launch_per_event(j):
    ctx, rctx = _contexts(j, seed=5)
    plan = Dispatcher(FirstInFirstOut(
        VectorizedAllocator("FF", device=CPU))).plan(ctx)
    rplan = RDispatcher(RFirstInFirstOut(RVectorizedAllocator("FF"))).plan(
        rctx)
    assert plan.stats["kernel_launches"] == 1 == rplan.stats["kernel_launches"]
    assert plan.stats["queued"] == j
    assert plan.trace() == rplan.trace()


def test_per_job_path_is_started_plus_one_launches():
    ctx, rctx = _contexts(48, seed=5)
    plan = Dispatcher(FirstInFirstOut(
        VectorizedAllocator("FF", batched=False, device=CPU))).plan(ctx)
    rplan = RDispatcher(RFirstInFirstOut(
        RVectorizedAllocator("FF", batched=False))).plan(rctx)
    assert plan.stats["kernel_launches"] == plan.n_started + 1 > 1
    assert plan.stats["kernel_launches"] == rplan.stats["kernel_launches"]
    assert plan.trace() == rplan.trace()


def test_vectorized_ebf_launches_independent_of_queue_depth():
    per_j = {}
    for j in (32, 96):
        ctx, rctx = _contexts(j, seed=7)
        plan = Dispatcher(VectorizedEasyBackfilling(
            VectorizedAllocator("FF", device=CPU))).plan(ctx)
        rplan = RDispatcher(RVectorizedEasyBackfilling(
            RVectorizedAllocator("FF"))).plan(rctx)
        assert plan.stats["kernel_launches"] == \
            rplan.stats["kernel_launches"]
        assert plan.trace() == rplan.trace()
        per_j[j] = plan.stats["kernel_launches"]
    assert per_j[32] == per_j[96] <= 3


# ---------------------------------------------------------------- replay
class _Recorder(RSchedulerBase):
    """Wraps a reference planner and keeps, per event, the context's
    arrays, its releases (read before the plan commits) and the plan."""

    def __init__(self, inner):
        super().__init__(inner.allocator)
        self.inner = inner
        self.name = inner.name
        self.events = []

    def plan(self, ctx):
        releases = [(t, n.copy(), v.copy()) for t, n, v in
                    ctx.release_tuples()]
        arrays = dict(
            now=ctx.now, req=ctx.req.copy(), n_nodes=ctx.n_nodes.copy(),
            est=ctx.est.copy(), queued_time=ctx.queued_time.copy(),
            avail=ctx.avail.copy(), capacity=ctx.capacity.copy(),
            node_mask=None if ctx.node_mask is None
            else ctx.node_mask.copy(),
            releases=releases,
            job_ids=[ctx.job_id(i) for i in range(ctx.n_queued)],
            resource_types=ctx.resource_types)
        plan = self.inner.plan(ctx)
        self.events.append((arrays, plan.trace()))
        return plan


def test_per_event_replay_of_reference_vebf_vbf(tmp_path):
    rec = _Recorder(RVectorizedEasyBackfilling(RVectorizedAllocator("BF")))
    failures = FailureInjector(10, mtbf_s=4000.0, repair_s=900.0,
                               horizon_s=6000, seed=3).arrays()
    sim = RSimulator(RSyntheticWorkload(150, **dict(WL, seed=7)), SYS, rec,
                     job_factory=RJobFactory(), output_dir=str(tmp_path),
                     name="rec", failures=failures, quarantine_s=1800)
    sim.start_simulation(write_output=False)
    masked = sum(1 for a, _ in rec.events if a["node_mask"] is not None)
    assert len(rec.events) > 50 and masked > 0
    port = VectorizedEasyBackfilling(VectorizedAllocator("BF", device=CPU))
    for arrays, want in rec.events:
        ctx = context_from_arrays(**arrays)
        assert port.plan(ctx).trace() == want, arrays["now"]


def test_vebf_runs_on_its_allocators_device():
    alloc = VectorizedAllocator("BF", device=CPU)
    assert VectorizedEasyBackfilling(alloc).device == torch.device(CPU)
    # a numpy allocator has no device to inherit: no hidden default
    with pytest.raises(TypeError, match="needs a VectorizedAllocator"):
        VectorizedEasyBackfilling(FirstFit())


# ---------------------------------------------------------------- BF ties
def test_bestfit_float64_and_vbf_float32_break_an_exact_tie_apart():
    """Numpy ``BestFit`` sums the load in float64, the vectorized path in
    float32 (the kernel's arithmetic).  On a node of capacity (2, 6), used
    (0, 5) and used (1, 2) tie exactly (5/6), but the two precisions
    round them in opposite directions, so BF and vBF pick different
    nodes.  The port keeps each engine's choice of the reference."""
    cap =np.array([[2, 6], [2, 6]], np.int64)
    avail = cap - np.array([[0, 5], [1, 2]], np.int64)
    req = np.array([1, 1], np.int64)
    got64 = BestFit().find_nodes(req, 1, avail, cap)
    got32 = VectorizedAllocator("BF", device=CPU).find_nodes(
        req, 1, avail, cap)
    assert list(got64) == list(RBestFit().find_nodes(req, 1, avail, cap)) \
        == [0]
    assert list(got32) == list(RVectorizedAllocator(
        "BF", batched=False).find_nodes(req, 1, avail, cap)) == [1]
