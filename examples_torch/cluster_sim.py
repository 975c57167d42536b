"""Cluster fusion demo — the paper's WMS dispatches the ASSIGNED
architectures onto a 2-pod TPU fleet (DESIGN.md §7):

* job profiles come from the real dry-run records (results/dryrun/),
* the fleet sees failures (MTBF model) with checkpoint/restart re-queue,
* a fault-aware EASY-backfilling dispatcher schedules around them,
* elastic scaling shrinks deep-queued training jobs into free hosts.

The profiles come from the port's dry-run records (``python -m
repro_torch.launch.dryrun``), whose roofline terms are reckoned from the
H100 constants of ``repro_torch.launch.mesh``.  Host only: no kernel
runs here.

    PYTHONPATH=src python examples_torch/cluster_sim.py
"""
import json
import os
import random
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.cluster import (ElasticScaler, FailureInjector,
                           FaultAwareScheduler, TPUJobFactory, load_profiles,
                           tpu_cluster_config)
from repro_torch.cluster.failures import CheckpointRestartPolicy
from repro_torch.core import NodeFailureModel, Simulator
from repro_torch.core.dispatchers import EasyBackfilling, FirstFit

OUT = "results/cluster_sim"


def main():
    profiles = load_profiles("results/dryrun", mesh="single")
    if not profiles:
        sys.exit("run the dry-run first: python -m repro.launch.dryrun")
    print(f"loaded {len(profiles)} job profiles from the dry-run")

    sys_cfg = tpu_cluster_config(n_pods=2, hosts_per_pod=64)   # 128 hosts
    factory = TPUJobFactory(profiles)
    rng = random.Random(0)

    # a day of submissions: training jobs (big, long) + serving jobs
    jobs = []
    t = 0
    train_keys = [k for k, p in profiles.items() if p.kind == "train"]
    decode_keys = [k for k, p in profiles.items() if p.kind == "decode"]
    for i in range(60):
        t += rng.randint(120, 1200)
        if rng.random() < 0.6 and train_keys:
            key = rng.choice(train_keys)
            job = factory.make_job(key, t, steps=rng.randint(20, 200),
                                   user=rng.randint(1, 8))
        else:
            key = rng.choice(decode_keys)
            job = factory.make_job(key, t, steps=rng.randint(2000, 20000),
                                   user=rng.randint(1, 8))
        # fleet is 128 hosts; cap request
        job.requested_nodes = min(job.requested_nodes, 64)
        jobs.append(job)

    horizon = max(j.submission_time for j in jobs) + 6 * 3600
    injector = FailureInjector(n_nodes=128, mtbf_s=30 * 3600,
                               repair_s=1800, horizon_s=horizon, seed=1)
    failure_model = NodeFailureModel(injector.trace())
    ckpt_policy = CheckpointRestartPolicy(ckpt_every_s=600)

    sched = FaultAwareScheduler(EasyBackfilling(FirstFit()))
    sim = Simulator(jobs, sys_cfg, sched, output_dir=OUT)

    # wire failure -> quarantine + checkpoint-restart accounting
    orig_update = failure_model.update
    def update(em):
        before = {j.id: (j.start_time, em.current_time) for j in em.running.values()}
        out = orig_update(em)
        for job in em.queue:
            if job.id in before and job.start_time is None:
                start, now = before[job.id]
                if start is not None:
                    ckpt_policy.on_requeue(job, now - start)
                sched.note_failure(em.current_time, -1)
        for node in out["failed_nodes"]:
            sched.note_failure(em.current_time, node)
        return out
    failure_model.update = update

    sim.start_simulation(additional_data=[failure_model])
    s = sim.summary
    print(json.dumps({
        "jobs": len(jobs),
        "completed": s["completed"],
        "requeued_after_failure": failure_model.requeued_jobs,
        "work_saved_by_checkpoints_s": ckpt_policy.recovered_work_s,
        "makespan_h": round(s["sim_end_time"] / 3600, 1),
        "failures_injected": len([e for e in injector.trace()
                                  if e[2] == "fail"]),
    }, indent=1))


if __name__ == "__main__":
    main()
