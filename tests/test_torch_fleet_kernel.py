"""The ``fleet_engine`` CUDA kernel against its plain PyTorch version.

The kernel runs a whole simulation per thread block; its final
:class:`SimState` must equal ``advance_plain``'s field by field, built in
the reference's order: FIFO/SJF/LJF x FF, then EBF and BF, then failures
(F > 0), then telemetry (S > 0), each with and without the fit-bit
prefilter, and with padded lanes.  Imports no JAX, so it runs on a GPU
machine with the port alone::

    python -m pytest -q -m cuda tests/test_torch_fleet_kernel.py

Without a card only the no-fallback checks run.
"""
import numpy as np
import pytest
import torch

from repro_torch.cluster import FailureInjector
from repro_torch.core.job import JobFactory
from repro_torch.fleet import (ALLOC_BF, ALLOC_FF, SCHED_EBF, SCHED_FIFO,
                               SCHED_LJF, SCHED_SJF, FleetRunner, SimState,
                               advance, advance_plain, stack, unstack)
from repro_torch.kernels import counters
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
