"""The plain reference simulator (``perfbench/reference/fleet_ref.py``):
against the repository's golden traces, against the port's plain
version on small Seth and RICC-sized streams, and with a guarantee
broken; and the Seth stream's generator against the port's
``seth_jobs``.

    python -m pytest -q perfbench/tests              # CPU
    python -m pytest -q -m cuda perfbench/tests      # on the card
"""
import json
import os

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.entries.fleet_grid import COUNTS, compare
from perfbench.reference import fleet_ref
from repro_torch.fleet.runner import FleetRunner, FleetSim
from repro_torch.workloads.synthetic import SyntheticWorkload

GOLDEN = os.path.join(harness.ROOT, "tests", "data", "golden_traces.json")
GOLDEN_SYS = {"groups": {"a": {"core": 4, "mem": 1024},
                         "b": {"core": 8, "mem": 2048}},
              "nodes": {"a": 6, "b": 4}}
POLICIES = [f"{s}-{a}" for s in fleet_ref.SCHEDULERS
            for a in fleet_ref.ALLOCATORS]
CODES = {"FIFO": 0, "SJF": 1, "LJF": 2, "EBF": 3, "FF": 0, "BF": 1}


def _golden_stream():
    recs = list(SyntheticWorkload(
        400, seed=29, mean_interarrival_s=25.0, duration_median_s=900.0,
        duration_sigma=1.1, node_weights={1: 0.5, 2: 0.3, 4: 0.2},
        resources={"core": (1, 4), "mem": (64, 1024)}))
    cols = {"submit": np.array([r["submit"] for r in recs]),
            "duration": np.array([r["duration"] for r in recs]),
            "expected": np.array([r["expected_duration"] for r in recs]),
            "nodes": np.array([r["requested_nodes"] for r in recs]),
            "req": {rt: np.array([r["requested_resources"].get(rt, 0)
                                  for r in recs]) for rt in ("core", "mem")}}
    return [str(r["id"]) for r in recs], cols


def _by_id(ids, trace):
    return {ids[int(k)]: v for k, v in trace.items()}


@pytest.mark.parametrize("policy", POLICIES)
def test_reference_matches_golden_traces(policy):
    with open(GOLDEN) as fh:
        want = json.load(fh)[policy]
    ids, cols = _golden_stream()
    got = _by_id(ids, fleet_ref.simulate(cols, GOLDEN_SYS, policy)["trace"])
    assert compare(got, want) == 0


SETH = harness.resolve("seth.grid")
#: a RICC-sized system (1024 nodes of 8 cores, 12 GB) under a denser
#: stream of wider jobs, so that queues form over many nodes
RICC = {"groups": {"ricc": {"core": 8, "mem": 12288}},
        "nodes": {"ricc": 1024}}
RICC_TRAFFIC = {"params": dict(
    SETH.traffic["params"], day_gap_s=20, night_gap_s=60,
    procs=[8, 64, 256, 1024, 4096], procs_per_node=8,
    mem_mb=[768, 1536, 12288])}
CASES = {"seth": (SETH.config["system"], SETH.traffic),
         "ricc": (RICC, RICC_TRAFFIC)}


def _stream(case, jobs, seed):
    system, traffic = CASES[case]
    st = SETH.generator().generate(traffic, seed, jobs)
    cols = {"submit": st.submit, "duration": st.duration,
            "expected": st.expected, "nodes": st.nodes, "req": st.req}
    return system, st, cols


def _port(system, st, device):
    base = FleetRunner.build("s", st.records(), system, sched_id=0)
    sims = [FleetSim(p, base.state._replace(
        sched_id=np.int32(CODES[p.split("-")[0]]),
        alloc_id=np.int32(CODES[p.split("-")[1]])), base.meta,
        CODES[p.split("-")[0]], CODES[p.split("-")[1]]) for p in POLICIES]
    return FleetRunner(device=device).run(sims)


@pytest.mark.parametrize("case,jobs,seed", [("seth", 800, 2**31 + 3),
                                            ("ricc", 500, 7)])
def test_reference_matches_the_ports_plain_version(case, jobs, seed):
    system, st, cols = _stream(case, jobs, seed)
    res = _port(system, st, "cpu")
    for i, policy in enumerate(POLICIES):
        ref = fleet_ref.simulate(cols, system, policy)
        summ = res.summary(i)
        assert [summ[c] for c in COUNTS] == [ref[c] for c in COUNTS]
        assert compare(res.trace(i), ref["trace"]) == 0, policy


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_the_seth_stream_draws_as_seth_jobs(seed):
    """At ``seth_jobs``' parameters the generator draws its jobs, job for
    job (the cell's traffic stretches its gaps and runtimes)."""
    from benchmarks_torch.common import seth_jobs

    traffic = {"params": dict(SETH.traffic["params"], day_gap_s=55,
                              night_gap_s=240, runtime_mu=7.2)}
    got = SETH.generator().generate(traffic, seed, 500).records()
    want = [{"id": j.id, "user": j.user_id, "submit": j.submission_time,
             "duration": j.duration, "expected_duration":
             j.expected_duration, "requested_nodes": j.requested_nodes,
             "requested_resources": dict(j.requested_resources)}
            for j in seth_jobs(500, seed)]
    assert got == want


@pytest.mark.parametrize("broken,policy", [("bf_ties", "FIFO-BF"),
                                           ("bf_ties", "EBF-BF"),
                                           ("reservation", "EBF-FF")])
def test_a_broken_guarantee_fails(broken, policy):
    ids, cols = _golden_stream()
    with open(GOLDEN) as fh:
        want = json.load(fh)[policy]
    got = fleet_ref.simulate(cols, GOLDEN_SYS, policy, broken=broken)
    assert compare(_by_id(ids, got["trace"]), want) > 0


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("case,jobs,seed", [("seth", 3000, 5),
                                            ("ricc", 1500, 6)])
def test_reference_matches_the_kernel(cuda_dev, case, jobs, seed):
    system, st, cols = _stream(case, jobs, seed)
    res = _port(system, st, cuda_dev)
    for i, policy in enumerate(POLICIES):
        ref = fleet_ref.simulate(cols, system, policy)
        summ = res.summary(i)
        assert [summ[c] for c in COUNTS] == [ref[c] for c in COUNTS]
        assert compare(res.trace(i), ref["trace"]) == 0, policy
