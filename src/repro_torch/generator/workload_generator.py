"""Synthetic workload generator (paper §7.3).

Mimics a real workload dataset's statistics:

* **Submission times** — the Slot Weight Method of Lublin & Feitelson
  [24]: a day is 48 half-hour slots, each weighted by its share of real
  submissions; a random inter-arrival budget ``v`` is walked through the
  circular slot list.  Two paper-specific modifications are implemented:
  (1) the fixed upper bound of ``v`` becomes the dataset's maximum
  inter-arrival time; (2) ``v_max`` adapts dynamically via the progress
  ratio ``pr`` of generated vs. real hourly/daily/monthly submission
  shares:  ``v_max <- v_max - (v_max - s) * (1 - pr)``.

* **Job shape** — serial/parallel selection and node counts follow the
  empirical distribution (modified per the paper to allow parallel jobs
  on a single node, i.e. multi-core requests).

* **Duration** — a random theoretical FLOP budget (fit in log space from
  the real dataset's ``duration × cores × per-core GFLOPS``) divided by
  the dot product of the generated request and the per-unit performance,
  times the node count — so the same FLOP distribution re-targets any
  synthetic system configuration (paper Figs. 16/17).
"""
from __future__ import annotations

import json
import math
import random
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

from ..workloads.reader import Reader
from ..workloads.swf import SWFReader, SWFWriter

SLOT_SECONDS = 1800
SLOTS_PER_DAY = 48


class WorkloadGenerator:
    def __init__(
        self,
        workload: str,
        sys_config: str | Dict,
        performance: Dict[str, float],         # GFLOPS per unit of each rtype
        request_limits: Dict[str, Dict[str, int]],
        reader: Optional[Reader] = None,
        writer=None,
        seed: int = 0,
        max_nodes_per_job: int = 16,
    ) -> None:
        self.reader = reader or SWFReader(workload)
        self.writer = writer or SWFWriter()
        if isinstance(sys_config, str):
            with open(sys_config) as fh:
                sys_config = json.load(fh)
        self.sys_config = sys_config
        self.performance = performance
        self.limits = request_limits
        self.rng = random.Random(seed)
        self.max_nodes = max_nodes_per_job
        self._fit()

    # ------------------------------------------------------------------
    def _fit(self) -> None:
        """One streaming pass over the real dataset -> statistics."""
        slot_counts = [0] * SLOTS_PER_DAY
        hour_counts = [0] * 24
        day_counts = [0] * 7
        month_counts = [0] * 12
        inter = []
        log_work = []
        node_hist: Dict[int, int] = defaultdict(int)
        n = 0
        prev_submit = None
        core_perf = self.performance.get("core", 1.0)
        for rec in self.reader:
            t = rec["submit"]
            slot_counts[(t // SLOT_SECONDS) % SLOTS_PER_DAY] += 1
            hour_counts[(t // 3600) % 24] += 1
            day_counts[(t // 86400) % 7] += 1
            month_counts[(t // (86400 * 30)) % 12] += 1
            if prev_submit is not None:
                inter.append(max(t - prev_submit, 0))
            prev_submit = t
            procs = max(int(rec.get("requested_processors", 1)), 1)
            node_hist[procs] += 1
            work = max(rec["duration"], 1) * procs * core_perf  # GFLOP proxy
            log_work.append(math.log(work))
            n += 1
        if n == 0:
            raise ValueError("empty real workload")
        self.n_real = n
        tot = float(n)
        self.slot_weights = [c / tot for c in slot_counts]
        self.hour_ratio = [c / tot for c in hour_counts]
        self.day_ratio = [c / tot for c in day_counts]
        self.month_ratio = [c / tot for c in month_counts]
        self.v_max0 = float(max(inter)) if inter else 3600.0   # paper mod (1)
        inter.sort()
        self.inter_sorted = inter or [60]
        mu = sum(log_work) / n
        var = sum((x - mu) ** 2 for x in log_work) / max(n - 1, 1)
        self.work_mu, self.work_sigma = mu, math.sqrt(var)
        self.serial_frac = node_hist.get(1, 0) / tot
        sizes = sorted(node_hist)
        self.size_choices = sizes
        self.size_weights = [node_hist[s] / tot for s in sizes]

    # ------------------------------------------------------------------
    def _sample_interarrival(self) -> float:
        """Empirical inverse-CDF sample of the inter-arrival time."""
        q = self.rng.random()
        idx = min(int(q * len(self.inter_sorted)), len(self.inter_sorted) - 1)
        return float(self.inter_sorted[idx])

    def _progress_ratio(self, gen_counts, n_generated, t) -> float:
        """Paper mod (2): generated-vs-real share ratios for the current
        hour / day / month, multiplied."""
        if n_generated == 0:
            return 1.0
        pr = 1.0
        pairs = [
            (self.hour_ratio[(t // 3600) % 24],
             gen_counts["hour"][(t // 3600) % 24] / n_generated),
            (self.day_ratio[(t // 86400) % 7],
             gen_counts["day"][(t // 86400) % 7] / n_generated),
        ]
        if any(self.month_ratio):
            pairs.append((self.month_ratio[(t // (86400 * 30)) % 12],
                          gen_counts["month"][(t // (86400 * 30)) % 12]
                          / n_generated))
        for real, gen in pairs:
            if real > 0:
                pr *= min(gen / real, 2.0) if gen > 0 else 0.5
        return max(min(pr, 2.0), 0.0)

    def _next_submission(self, prev_t: int, v_max: float) -> int:
        """Slot Weight Method walk."""
        v = self._sample_interarrival() % max(v_max, 1.0)
        v_days = v / 86400.0
        slot = (prev_t // SLOT_SECONDS) % SLOTS_PER_DAY
        elapsed = 0
        budget = v_days
        # walk the circular slot list subtracting weights
        for _ in range(SLOTS_PER_DAY * 8):        # bounded walk
            w = max(self.slot_weights[slot], 1e-6)
            if budget < w:
                break
            budget -= w
            slot = (slot + 1) % SLOTS_PER_DAY
            elapsed += SLOT_SECONDS
        frac = budget / max(self.slot_weights[slot], 1e-6)
        return prev_t + max(int(elapsed + frac * SLOT_SECONDS), 1)

    def _sample_request(self) -> Dict[str, int]:
        req = {}
        for rt, lo in self.limits["min"].items():
            hi = self.limits["max"][rt]
            req[rt] = self.rng.randint(int(lo), int(hi))
        return req

    def _sample_nodes(self) -> int:
        if self.rng.random() < self.serial_frac:
            return 1
        procs = self.rng.choices(self.size_choices, self.size_weights)[0]
        # paper mod: parallel jobs may stay on one node (multi-core)
        return max(1, min(self.max_nodes, int(round(procs ** 0.5))))

    # ------------------------------------------------------------------
    def generate_jobs(self, n_jobs: int, out_path: Optional[str] = None
                      ) -> List[Dict]:
        jobs = []
        t = 0
        v_max = self.v_max0
        gen_counts = {"hour": defaultdict(int), "day": defaultdict(int),
                      "month": defaultdict(int)}
        for i in range(n_jobs):
            t = self._next_submission(t, v_max)
            pr = self._progress_ratio(gen_counts, i, t)
            v_max = v_max - (v_max - SLOT_SECONDS) * (1.0 - pr)
            v_max = max(min(v_max, self.v_max0), SLOT_SECONDS)
            gen_counts["hour"][(t // 3600) % 24] += 1
            gen_counts["day"][(t // 86400) % 7] += 1
            gen_counts["month"][(t // (86400 * 30)) % 12] += 1

            nodes = self._sample_nodes()
            req = self._sample_request()
            # duration = FLOPs / (request · performance × nodes)
            work = math.exp(self.rng.gauss(self.work_mu, self.work_sigma))
            perf = sum(req.get(rt, 0) * gf
                       for rt, gf in self.performance.items())
            duration = max(int(work / max(perf * nodes, 1e-9)), 1)
            duration = min(duration, 7 * 86400)
            cores_total = req.get("core", 1) * nodes
            jobs.append({
                "id": i + 1,
                "submit": t,
                "duration": duration,
                "expected_duration": min(int(duration * self.rng.uniform(1.0, 3.0)) + 60,
                                          8 * 86400),
                "requested_processors": cores_total,
                "requested_memory": req.get("mem", 0),
                "user": self.rng.randint(1, 100),
                "status": 1,
                "work_gflop": work,
            })
        if out_path:
            self.writer.write(iter(jobs), out_path)
        return jobs
