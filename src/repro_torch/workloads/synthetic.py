"""Parameterized synthetic workload generator.

Produces seeded, lazily-streamed workload records directly usable as a
``Simulator`` workload source (and by the core benchmarks): Poisson
arrivals, lognormal durations, configurable node-count and per-node
resource-request distributions.  Unlike :mod:`repro_torch.generator`
(which *mimics* a real trace's empirical distributions, paper §7.3),
this module generates from first-principles parametric distributions — it opens
scenario diversity beyond SWF files and needs no input trace.

Records carry BOTH request representations so any job factory works:

* ``requested_nodes`` / ``requested_resources`` — consumed directly by a
  mapper-less :class:`~repro_torch.core.job.JobFactory`;
* ``requested_processors`` / ``requested_memory`` — the SWF-style totals
  consumed by ``swf_resource_mapper`` (the Simulator default).

Determinism: iterating the same ``SyntheticWorkload`` twice yields the
identical stream (a fresh ``random.Random(seed)`` per iteration), so a
single instance can seed several simulations of the same scenario.
"""
from __future__ import annotations

import copy
import random
from math import log
from typing import Dict, Iterator, Optional, Sequence, Tuple

from .reader import Reader


class SyntheticWorkload(Reader):
    """Seeded parametric workload stream.

    Parameters
    ----------
    n_jobs:
        Number of records to yield.
    seed:
        RNG seed; two instances with equal parameters produce equal
        streams.
    mean_interarrival_s:
        Poisson arrival process: exponential inter-arrival times with
        this mean (seconds).
    duration_median_s / duration_sigma:
        Lognormal true-runtime distribution, parameterized by its median
        (``exp(mu)``) and shape ``sigma``.
    over_estimate:
        ``(lo, hi)`` uniform factor applied to the true runtime to form
        the user walltime estimate (users over-estimate; paper §7).
    node_weights:
        ``{node_count: weight}`` categorical distribution of
        ``requested_nodes``.
    resources:
        ``{resource_type: (lo, hi)}`` inclusive uniform integer ranges
        for the per-node request vector.
    cores_per_node:
        Used only to derive the SWF-style ``requested_processors`` total
        from the per-node ``core`` request (for mapper-based factories).
    n_users:
        User ids are drawn uniformly from ``1..n_users``.
    start:
        Submission time of the arrival process origin (seconds).
    max_duration_s:
        Hard cap on true runtimes (lognormal tails are long).
    """

    def __init__(
        self,
        n_jobs: int,
        seed: int = 0,
        mean_interarrival_s: float = 60.0,
        duration_median_s: float = 600.0,
        duration_sigma: float = 1.0,
        over_estimate: Tuple[float, float] = (1.0, 3.0),
        node_weights: Optional[Dict[int, float]] = None,
        resources: Optional[Dict[str, Tuple[int, int]]] = None,
        cores_per_node: int = 4,
        n_users: int = 10,
        start: int = 0,
        max_duration_s: int = 7 * 86400,
    ) -> None:
        if n_jobs <= 0:
            raise ValueError("n_jobs must be positive")
        if mean_interarrival_s <= 0:
            raise ValueError("mean_interarrival_s must be positive")
        self.n_jobs = int(n_jobs)
        self.seed = seed
        self.mean_interarrival_s = float(mean_interarrival_s)
        self.duration_mu = log(max(duration_median_s, 1.0))
        self.duration_sigma = float(duration_sigma)
        self.over_estimate = over_estimate
        node_weights = node_weights or {1: 0.55, 2: 0.25, 4: 0.15, 8: 0.05}
        self._node_choices = sorted(node_weights)
        self._node_cum: Sequence[float] = self._cumulative(
            [node_weights[k] for k in self._node_choices])
        self.resources = dict(resources or {"core": (1, 4), "mem": (64, 1024)})
        self.cores_per_node = int(cores_per_node)
        self.n_users = max(1, int(n_users))
        self.start = int(start)
        self.max_duration_s = int(max_duration_s)

    def reseed(self, seed: int) -> "SyntheticWorkload":
        """Same scenario, different RNG seed: a shallow copy whose stream
        re-derives from ``seed``.  ``Experiment`` uses this to give every
        repeat an independent arrival/duration draw
        (``base_seed + rep``)."""
        clone = copy.copy(self)
        clone.seed = int(seed)
        return clone

    @staticmethod
    def _cumulative(weights: Sequence[float]) -> Sequence[float]:
        total = float(sum(weights))
        if total <= 0:
            raise ValueError("node_weights must sum to a positive value")
        acc, out = 0.0, []
        for w in weights:
            acc += w / total
            out.append(acc)
        out[-1] = 1.0
        return out

    def _pick_nodes(self, u: float) -> int:
        for k, edge in zip(self._node_choices, self._node_cum):
            if u <= edge:
                return k
        return self._node_choices[-1]

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, object]]:
        rng = random.Random(self.seed)
        t = float(self.start)
        for i in range(self.n_jobs):
            t += rng.expovariate(1.0 / self.mean_interarrival_s)
            duration = int(rng.lognormvariate(self.duration_mu,
                                              self.duration_sigma))
            duration = min(max(duration, 1), self.max_duration_s)
            est = int(duration * rng.uniform(*self.over_estimate))
            nodes = self._pick_nodes(rng.random())
            per_node = {rt: rng.randint(lo, hi)
                        for rt, (lo, hi) in self.resources.items()}
            cores = per_node.get("core", 1)
            yield {
                "id": i + 1,
                "submit": int(t),
                "duration": duration,
                "expected_duration": max(est, duration),
                "requested_nodes": nodes,
                "requested_resources": per_node,
                # SWF-style totals for swf_resource_mapper-based factories
                "requested_processors": max(cores, 1) * nodes,
                "requested_memory": per_node.get("mem", 0) * nodes,
                "user": rng.randint(1, self.n_users),
                "status": 1,
            }
