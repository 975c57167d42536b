"""Elastic scaling + straggler mitigation policies (DESIGN §7).

``ElasticScaler`` resizes *elastic* jobs (those whose profile has a
scaling curve) at dispatch time: when the queue is deep it admits jobs at
reduced chip counts; when the system drains it grows them — the
checkpoint-reshard path (the reference's ``checkpoint`` package, not
ported yet) makes this executable on real hardware, here it drives the
simulation.

``StragglerMonitor`` models slow hosts: hosts with a slowdown factor
stretch the effective duration of jobs touching them; the monitor detects
persistent stragglers from per-host completion statistics and feeds the
quarantine list of ``FaultAwareScheduler`` — the WMS-level analogue of
straggler mitigation in synchronous data-parallel training.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from ..core.job import Job
from .job_profiles import JobProfile, scaling_curve
from .tpu_cluster import CHIPS_PER_HOST


class ElasticScaler:
    def __init__(self, profiles: Dict[str, JobProfile],
                 min_hosts: int = 4, deep_queue: int = 8) -> None:
        self.profiles = profiles
        self.min_hosts = min_hosts
        self.deep_queue = deep_queue
        self.shrunk = 0
        self.grown = 0

    def admit(self, job: Job, queue_depth: int, free_hosts: int) -> Job:
        """Possibly rewrite the job's node request before dispatch."""
        key = job.attrs.get("profile")
        prof = self.profiles.get(key) if key else None
        if prof is None or job.attrs.get("kind") == "decode":
            return job
        want = job.requested_nodes
        if queue_depth >= self.deep_queue and free_hosts < want:
            new_hosts = max(self.min_hosts, free_hosts)
            if new_hosts < want and new_hosts >= self.min_hosts:
                ratio = scaling_curve(prof, new_hosts * CHIPS_PER_HOST) \
                    / prof.step_time_s
                job.requested_nodes = new_hosts
                job.duration = max(int(job.duration * ratio), 1)
                job.expected_duration = max(int(job.expected_duration * ratio), 1)
                job.attrs["elastic"] = f"shrunk {want}->{new_hosts}"
                self.shrunk += 1
        return job


class StragglerMonitor:
    """Detects slow hosts from observed vs expected job runtimes.

    ``observe`` accepts row-view ``Job`` façades in any binding state:
    a bound row, or a façade detached when its row was recycled (the
    table snapshots final values into the façade on ``free_row``, so
    reads never raise on staleness).  With ``expected_duration`` omitted
    it uses the job's own walltime estimate, which makes the monitor
    directly wireable as an ``on_complete`` callback.
    """

    def __init__(self, slow_threshold: float = 1.15,
                 min_samples: int = 3) -> None:
        self.host_ratio: Dict[int, List[float]] = defaultdict(list)
        self.slow_threshold = slow_threshold
        self.min_samples = min_samples

    def observe(self, job: Job,
                expected_duration: Optional[int] = None) -> None:
        if job.start_time is None or job.end_time is None:
            return
        if job.attrs.get("restarts"):
            # failure-requeued job: its final segment runs with a
            # checkpoint-credited (rewritten) duration on different
            # nodes than the lost segment — not a valid host sample
            return
        if expected_duration is None:
            expected_duration = job.expected_duration
        actual = job.end_time - job.start_time
        ratio = actual / max(expected_duration, 1)
        for node in job.assigned_nodes:
            self.host_ratio[int(node)].append(ratio)

    def stragglers(self) -> List[int]:
        out = []
        for node, ratios in self.host_ratio.items():
            if len(ratios) >= self.min_samples:
                avg = sum(ratios[-10:]) / len(ratios[-10:])
                if avg >= self.slow_threshold:
                    out.append(node)
        return sorted(out)


class SlowHostModel:
    """Deterministic straggler injection: listed hosts stretch any job
    that touches them by ``factor`` (applied by the cluster layer before
    start_job)."""

    def __init__(self, slow_hosts: Dict[int, float]) -> None:
        self.slow_hosts = dict(slow_hosts)

    def effective_duration(self, job: Job,
                           nodes: Optional[List[int]] = None) -> int:
        if nodes is None:
            nodes = job.assigned_nodes    # works bound or detached
        f = max([self.slow_hosts.get(int(n), 1.0) for n in nodes] + [1.0])
        return max(int(job.duration * f), 1)
