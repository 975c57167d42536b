"""TPU fleet as an AccaSim synthetic system (the fusion layer, DESIGN §4).

A v5e pod = 64 hosts × 4 chips = 256 chips.  The WMS manages *hosts* as
nodes with resources {chip: 4, hbm_gib: 64, host_ram_gib: 192}; a
training/serving job of an assigned architecture requests whole hosts
(multi-node jobs), exactly like MPI jobs on a classic HPC system — so the
paper's dispatchers schedule LM workloads unchanged.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..core.job import Job

CHIPS_PER_HOST = 4
HBM_GIB_PER_CHIP = 16


def tpu_cluster_config(n_pods: int = 2, hosts_per_pod: int = 64) -> Dict:
    """AccaSim system-config dict for an ``n_pods`` v5e fleet."""
    return {
        "groups": {
            "tpu_host": {
                "chip": CHIPS_PER_HOST,
                "hbm_gib": CHIPS_PER_HOST * HBM_GIB_PER_CHIP,
                "host_ram_gib": 192,
            }
        },
        "nodes": {"tpu_host": n_pods * hosts_per_pod},
    }


class TPUJobFactory:
    """Builds WMS jobs from architecture job profiles (job_profiles.py).

    duration = steps × bound step time (from the dry-run roofline);
    request  = hosts covering the profile's chip count.
    """

    def __init__(self, profiles: Dict[str, "JobProfile"]) -> None:
        self.profiles = profiles
        self._next = 0

    def make_job(self, profile_key: str, submit_time: int, steps: int,
                 user: int = 0) -> Job:
        from .job_profiles import JobProfile  # noqa: F401
        prof = self.profiles[profile_key]
        hosts = max(1, prof.chips // CHIPS_PER_HOST)
        duration = max(int(steps * prof.step_time_s), 1)
        self._next += 1
        job = Job(
            id=f"{profile_key}#{self._next}",
            user_id=user,
            submission_time=submit_time,
            duration=duration,
            expected_duration=int(duration * 1.2) + 60,
            requested_nodes=hosts,
            requested_resources={
                "chip": CHIPS_PER_HOST,
                "hbm_gib": min(
                    CHIPS_PER_HOST * HBM_GIB_PER_CHIP,
                    -(-int(prof.hbm_bytes_per_chip * CHIPS_PER_HOST) //
                      2**30)),
            },
        )
        job.attrs["profile"] = profile_key
        job.attrs["arch"] = prof.arch
        job.attrs["kind"] = prof.kind
        return job
