"""The port's host-only policy modules against the reference.

``cluster/*`` (failure injection, checkpoint/restart, fault-aware and
elastic scheduling, straggler detection, job profiles), the advanced
dispatchers (``PriorityAging``, ``WalltimeCorrectedEBF``,
``EnergyCappedScheduler``) and the workload generator: the checks of the
reference's ``test_cluster.py``, ``test_advanced_dispatchers.py`` and
``test_generator.py`` restated against ``repro_torch``, plus equality
with the reference on the same seeded inputs.
"""
import json
import math
import os
import random

import numpy as np
import pytest

import repro.cluster as ref_cluster
import repro.core as ref_core
import repro.core.dispatchers as ref_disp
from repro.experimentation import metrics
from repro.generator import WorkloadGenerator as RefWorkloadGenerator
from repro_torch.cluster import (ElasticScaler, FailureInjector,
                                 FaultAwareScheduler, JobProfile,
                                 StragglerMonitor, TPUJobFactory,
                                 profile_from_dryrun, tpu_cluster_config)
from repro_torch.cluster.elastic import SlowHostModel
from repro_torch.cluster.failures import CheckpointRestartPolicy
from repro_torch.core import (EventManager, Job, NodeFailureModel,
                              PowerModel, ResourceManager, Simulator)
from repro_torch.core.dispatchers import (DispatchContext, EasyBackfilling,
                                          EnergyCappedScheduler, FirstFit,
                                          FirstInFirstOut, PriorityAging,
                                          WalltimeCorrectedEBF)
from repro_torch.generator import WorkloadGenerator
from repro_torch.workloads import SWFReader, SWFWriter

ADV_SYS = {"groups": {"n": {"core": 4, "mem": 1024}}, "nodes": {"n": 8}}
GEN_SYS = {"groups": {"compute": {"core": 4, "mem": 1024}},
           "nodes": {"compute": 16}}
GEN_LIMITS = {"min": {"core": 1, "mem": 64}, "max": {"core": 4, "mem": 1024}}


# ----------------------------------------------------------------------
# cluster/
# ----------------------------------------------------------------------
def make_profiles(cls=JobProfile):
    return {
        "qwen3-1.7b/train_4k": cls(
            key="qwen3-1.7b/train_4k", arch="qwen3-1.7b", shape="train_4k",
            kind="train", chips=256, step_time_s=2.0, dominant="memory",
            hbm_bytes_per_chip=6e9, flops_per_chip=4e13,
            useful_flops_ratio=0.6),
        "smollm-360m/decode_32k": cls(
            key="smollm-360m/decode_32k", arch="smollm-360m",
            shape="decode_32k", kind="decode", chips=64, step_time_s=0.05,
            dominant="memory", hbm_bytes_per_chip=2e9, flops_per_chip=1e11,
            useful_flops_ratio=0.2),
    }


def _cluster_jobs(factory):
    jobs = [factory.make_job("qwen3-1.7b/train_4k", submit_time=i * 200,
                             steps=100 + 10 * i, user=i % 3)
            for i in range(10)]
    jobs += [factory.make_job("smollm-360m/decode_32k", submit_time=i * 300,
                              steps=2000) for i in range(5)]
    jobs.sort(key=lambda j: j.submission_time)
    return jobs


def test_tpu_cluster_jobs_schedule_like_the_reference(tmp_path):
    assert tpu_cluster_config(3, 8) == ref_cluster.tpu_cluster_config(3, 8)
    sim = Simulator(_cluster_jobs(TPUJobFactory(make_profiles())),
                    tpu_cluster_config(n_pods=2),
                    EasyBackfilling(FirstFit()), output_dir=str(tmp_path),
                    name="port")
    out = sim.start_simulation()
    assert sim.summary["completed"] == 15
    ref_sim = ref_core.Simulator(
        _cluster_jobs(ref_cluster.TPUJobFactory(
            make_profiles(ref_cluster.JobProfile))),
        ref_cluster.tpu_cluster_config(n_pods=2),
        ref_disp.EasyBackfilling(ref_disp.FirstFit()),
        output_dir=str(tmp_path), name="ref")
    ref_out = ref_sim.start_simulation()
    with open(out) as a, open(ref_out) as b:
        assert a.read() == b.read()


def test_failure_injection_requeues(tmp_path):
    """A node failure mid-run re-queues the victim job; it completes."""
    jobs = [Job(id="j", user_id=0, submission_time=0, duration=1000,
                expected_duration=1000, requested_nodes=2,
                requested_resources={"chip": 4, "hbm_gib": 64})]
    fm = NodeFailureModel([(500, 0, "fail")])      # node 0 dies at t=500
    sim = Simulator(jobs, tpu_cluster_config(n_pods=1, hosts_per_pod=4),
                    FirstInFirstOut(FirstFit()), output_dir=str(tmp_path))
    sim.start_simulation(additional_data=[fm])
    assert fm.requeued_jobs == 1
    assert sim.summary["completed"] == 1


def test_checkpoint_restart_policy():
    job = Job(id="t", user_id=0, submission_time=0, duration=1000,
              expected_duration=1200, requested_nodes=1,
              requested_resources={"chip": 4})
    pol = CheckpointRestartPolicy(ckpt_every_s=300)
    pol.on_requeue(job, ran_for_s=650)   # 2 checkpoints -> 600s saved
    assert job.duration == 400
    assert job.attrs["restarts"] == 1
    assert pol.recovered_work_s == 600


def test_fault_aware_scheduler_avoids_quarantined():
    rm = ResourceManager(tpu_cluster_config(n_pods=1, hosts_per_pod=4))
    job = Job(id="a", user_id=0, submission_time=0, duration=10,
              expected_duration=10, requested_nodes=2,
              requested_resources={"chip": 4})
    em = EventManager(iter([job]), rm)
    em.advance_to(0)
    sched = FaultAwareScheduler(FirstInFirstOut(FirstFit()))
    sched.note_failure(0, 0)
    sched.note_failure(0, 1)
    plan = sched.plan(DispatchContext.from_event_manager(0, em))
    assert plan.n_started == 1
    nodes = plan.starts[0][1]
    assert 0 not in nodes and 1 not in nodes


@pytest.mark.parametrize("seed", [4, 9])
def test_failure_injector_matches_the_reference(seed):
    a = FailureInjector(8, mtbf_s=5000, repair_s=600, horizon_s=50000,
                        seed=seed)
    b = FailureInjector(8, mtbf_s=5000, repair_s=600, horizon_s=50000,
                        seed=seed)
    assert a.trace() == b.trace() and len(a.trace()) > 0
    r = ref_cluster.FailureInjector(8, mtbf_s=5000, repair_s=600,
                                    horizon_s=50000, seed=seed)
    for mine, theirs in zip(a.arrays(), r.arrays()):
        assert mine.dtype == theirs.dtype
        np.testing.assert_array_equal(mine, theirs)


def test_failure_injector_arrays():
    """Sorted by (time, node), fail/repair alternating per node with
    repair_s gaps, consistent with the tuple view, and seed-sensitive."""
    inj = FailureInjector(6, mtbf_s=4000, repair_s=600, horizon_s=40000,
                          seed=9)
    times, nodes, is_fail = inj.arrays()
    assert times.dtype == np.int64 and nodes.dtype == np.int64
    assert is_fail.dtype == bool
    assert times.shape == nodes.shape == is_fail.shape
    order = np.lexsort((nodes, times))
    assert np.array_equal(order, np.arange(len(times)))
    assert inj.trace() == [
        (int(t), int(n), "fail" if f else "repair")
        for t, n, f in zip(times, nodes, is_fail)]
    for node in range(6):
        sel = nodes == node
        t_n, f_n = times[sel], is_fail[sel]
        assert f_n[0]
        assert (f_n[:-1] != f_n[1:]).all()
        rep = np.flatnonzero(~f_n)
        assert (t_n[rep] - t_n[rep - 1] == 600).all()
    assert (times < 40000).all() and times.min() >= 0
    other = FailureInjector(6, mtbf_s=4000, repair_s=600, horizon_s=40000,
                            seed=10)
    assert inj.trace() != other.trace()


def test_elastic_scaler_shrinks_under_pressure():
    profiles = make_profiles()
    factory = TPUJobFactory(profiles)
    scaler = ElasticScaler(profiles, min_hosts=4, deep_queue=2)
    job = factory.make_job("qwen3-1.7b/train_4k", 0, steps=100)
    want = job.requested_nodes
    d0 = job.duration
    out = scaler.admit(job, queue_depth=5, free_hosts=8)
    assert out.requested_nodes == 8 < want
    assert out.duration > d0            # fewer chips -> longer job
    assert scaler.shrunk == 1


def test_straggler_monitor_and_slow_host_model():
    mon = StragglerMonitor(slow_threshold=1.2, min_samples=2)
    slow_model = SlowHostModel({3: 1.5})
    for i in range(8):
        j = Job(id=str(i), user_id=0, submission_time=0, duration=100,
                expected_duration=100, requested_nodes=1,
                requested_resources={"chip": 1})
        j.start_time = 0
        slow = (i % 2 == 0)
        j.end_time = 150 if slow else 100
        j.assigned_nodes = [3] if slow else [7]
        mon.observe(j, expected_duration=100)
        assert slow_model.effective_duration(j) == (150 if slow else 100)
    assert mon.stragglers() == [3]


def test_profile_from_dryrun_record():
    rec = {
        "ok": True, "arch": "x", "shape": "train_4k", "chips": 256,
        "roofline": {"bound_step_time_s": 1.5, "dominant": "compute",
                     "model_flops_per_chip": 1e12,
                     "useful_flops_ratio": 0.5},
        "memory": {"per_device_bytes": 5e9},
    }
    p = profile_from_dryrun(rec)
    assert p.kind == "train" and p.step_time_s == 1.5 and p.chips == 256
    assert p == JobProfile(**vars(ref_cluster.profile_from_dryrun(rec)))
    assert profile_from_dryrun({"ok": False}) is None


# ----------------------------------------------------------------------
# core/dispatchers/advanced.py
# ----------------------------------------------------------------------
def make_jobs(n=250, seed=5, over_estimate=4, job_cls=Job):
    rng = random.Random(seed)
    out = []
    t = 0
    for i in range(n):
        t += rng.randint(1, 30)
        dur = rng.randint(20, 600)
        out.append(job_cls(id=str(i), user_id=rng.randint(1, 5),
                           submission_time=t, duration=dur,
                           expected_duration=dur * over_estimate,
                           requested_nodes=rng.randint(1, 3),
                           requested_resources={"core": rng.randint(1, 4),
                                                "mem": rng.randint(64, 512)}))
    return out


def test_priority_aging_prefers_high_priority(tmp_path):
    jobs = [Job(id=name, user_id=0, submission_time=t, duration=d,
                expected_duration=d, requested_nodes=8,
                requested_resources={"core": 4})
            for name, t, d in (("fill", 0, 100), ("low", 1, 10),
                               ("high", 2, 10))]
    jobs[2].attrs["priority"] = 100
    sim = Simulator(jobs, ADV_SYS, PriorityAging(FirstFit()),
                    output_dir=str(tmp_path))
    out = sim.start_simulation()
    assert sim.summary["completed"] == 3
    with open(out) as fh:
        start = {r["id"]: r["start"] for r in map(json.loads, fh)}
    assert start["high"] < start["low"]


def _aged(job_cls, n=150, seed=6):
    jobs = make_jobs(n, seed=seed, job_cls=job_cls)
    for j in jobs:
        j.attrs["priority"] = 10 if int(j.id) % 3 else 0
    return jobs


def test_priority_aging_no_starvation_like_the_reference(tmp_path):
    sim = Simulator(_aged(Job), ADV_SYS,
                    PriorityAging(FirstFit(), age_weight=1 / 600.0),
                    output_dir=str(tmp_path), name="port")
    out = sim.start_simulation()
    assert sim.summary["completed"] == 150
    ref_sim = ref_core.Simulator(
        _aged(ref_core.Job), ADV_SYS,
        ref_disp.PriorityAging(ref_disp.FirstFit(), age_weight=1 / 600.0),
        output_dir=str(tmp_path), name="ref")
    ref_out = ref_sim.start_simulation()
    with open(out) as a, open(ref_out) as b:
        assert a.read() == b.read()


def test_walltime_corrected_ebf_learns_and_helps(tmp_path):
    """With 4x-inflated user estimates, the data-driven EBF matches or
    beats plain EBF on mean slowdown, and its model learned ratios < 1."""
    sim_a = Simulator(make_jobs(400, seed=7), ADV_SYS,
                      EasyBackfilling(FirstFit()),
                      output_dir=str(tmp_path), name="ebf")
    out_a = sim_a.start_simulation()
    debf = WalltimeCorrectedEBF(FirstFit())
    sim_b = Simulator(make_jobs(400, seed=7), ADV_SYS, debf,
                      output_dir=str(tmp_path), name="debf")
    out_b = sim_b.start_simulation()
    assert sim_b.summary["completed"] == 400
    ratios = [debf._sum[u] / debf._cnt[u] for u in debf._cnt]
    assert ratios and all(r < 0.5 for r in ratios)   # learned ~1/4
    sl_a = metrics.percentiles(metrics.slowdowns(out_a))["mean"]
    sl_b = metrics.percentiles(metrics.slowdowns(out_b))["mean"]
    assert sl_b <= sl_a * 1.05
    ref_debf = ref_disp.WalltimeCorrectedEBF(ref_disp.FirstFit())
    ref_out = ref_core.Simulator(
        make_jobs(400, seed=7, job_cls=ref_core.Job), ADV_SYS, ref_debf,
        output_dir=str(tmp_path), name="ref-debf").start_simulation()
    with open(out_b) as a, open(ref_out) as b:
        assert a.read() == b.read()


def test_energy_cap_defers_and_caps(tmp_path):
    watts = {"core": 50.0}
    cap = 8 * 50.0 * 4 * 0.6 + 8 * 10.0     # 60% of full-load power
    sched = EnergyCappedScheduler(EasyBackfilling(FirstFit()), watts,
                                  cap_watts=cap, idle_node_watts=10.0)
    pm = PowerModel(watts, idle_node_watts=10.0)
    sim = Simulator(make_jobs(200, seed=8), ADV_SYS, sched,
                    output_dir=str(tmp_path), name="ecap")
    sim.start_simulation(additional_data=[pm])
    assert sim.summary["completed"] == 200
    assert sched.deferred > 0
    ref_sched = ref_disp.EnergyCappedScheduler(
        ref_disp.EasyBackfilling(ref_disp.FirstFit()), watts,
        cap_watts=cap, idle_node_watts=10.0)
    ref_core.Simulator(
        make_jobs(200, seed=8, job_cls=ref_core.Job), ADV_SYS, ref_sched,
        output_dir=str(tmp_path), name="ref-ecap").start_simulation(
        additional_data=[ref_core.PowerModel(watts, idle_node_watts=10.0)])
    assert sched.deferred == ref_sched.deferred


def test_observe_completion_only_for_completed(tmp_path):
    """Rejected jobs must not poison the walltime model."""
    debf = WalltimeCorrectedEBF(FirstFit())
    jobs = [Job(id="toobig", user_id=1, submission_time=0, duration=10,
                expected_duration=40, requested_nodes=1,
                requested_resources={"core": 99})]
    sim = Simulator(jobs, ADV_SYS, debf, output_dir=str(tmp_path),
                    name="rej")
    sim.start_simulation(write_output=False)
    assert sim.summary["rejected"] == 1
    assert not debf._cnt


# ----------------------------------------------------------------------
# generator/
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def real_swf(tmp_path_factory):
    """A synthetic 'real' trace with a clear daily cycle (working hours)."""
    rng = random.Random(5)
    recs = []
    t = 0
    for i in range(3000):
        t += int(rng.expovariate(1 / 180.0))
        hour = (t // 3600) % 24
        if not (8 <= hour <= 18) and rng.random() < 0.8:
            t += 3600 * 4
        procs = rng.choice([1, 1, 1, 2, 4, 8, 16])
        recs.append({"id": i + 1, "submit": t,
                     "duration": rng.randint(60, 7200),
                     "expected_duration": rng.randint(60, 9000),
                     "requested_processors": procs,
                     "requested_memory": rng.randint(64, 1024),
                     "user": rng.randint(1, 20), "status": 1})
    p = str(tmp_path_factory.mktemp("gen") / "real.swf")
    SWFWriter().write(iter(recs), p)
    return p


def test_generator_produces_sorted_valid_jobs(real_swf, tmp_path):
    gen = WorkloadGenerator(real_swf, GEN_SYS, {"core": 1.667}, GEN_LIMITS,
                            seed=3)
    out = os.path.join(str(tmp_path), "synthetic.swf")
    jobs = gen.generate_jobs(2000, out)
    assert len(jobs) == 2000
    subs = [j["submit"] for j in jobs]
    assert subs == sorted(subs)
    assert all(j["duration"] >= 1 for j in jobs)
    assert all(1 <= j["requested_processors"] for j in jobs)
    assert len(list(SWFReader(out))) == 2000
    ref = RefWorkloadGenerator(real_swf, GEN_SYS, {"core": 1.667},
                               GEN_LIMITS, seed=3)
    assert ref.generate_jobs(2000) == jobs


def test_generator_mimics_daily_cycle(real_swf):
    """Hourly submission shares of the generated workload correlate with
    the real trace (paper Fig. 14)."""
    gen = WorkloadGenerator(real_swf, GEN_SYS, {"core": 1.667}, GEN_LIMITS,
                            seed=7)
    jobs = gen.generate_jobs(4000)
    h = [0] * 24
    for j in jobs:
        h[(j["submit"] // 3600) % 24] += 1
    synth = [c / sum(h) for c in h]
    real = gen.hour_ratio
    mr, ms = sum(real) / 24, sum(synth) / 24
    num = sum((a - mr) * (b - ms) for a, b in zip(real, synth))
    den = math.sqrt(sum((a - mr) ** 2 for a in real)
                    * sum((b - ms) ** 2 for b in synth))
    corr = num / den if den else 0.0
    assert corr > 0.5, f"hourly-cycle correlation too low: {corr:.2f}"


def test_generator_work_distribution(real_swf):
    """Generated FLOP budgets follow the fitted log-normal (paper Fig. 16):
    log-mean within 1 sigma of the real fit."""
    gen = WorkloadGenerator(real_swf, GEN_SYS, {"core": 1.667}, GEN_LIMITS,
                            seed=11)
    logs = [math.log(j["work_gflop"]) for j in gen.generate_jobs(3000)]
    assert abs(sum(logs) / len(logs) - gen.work_mu) < gen.work_sigma
