"""The Seth stream: Poisson arrivals with a daily cycle, processor
counts drawn from a list, log-normal runtimes and padded estimates.

Every number comes from the traffic file's ``params``; the draws come
from one ``random.Random(seed)`` in a fixed order, so that at the
parameters of the port's ``benchmarks_torch/common.py`` ``seth_jobs``
(day and night gaps 55 and 240 s, runtime mu 7.2) it draws the same
jobs as that generator.
"""
from __future__ import annotations

import random
from typing import Dict

import numpy as np

from perfbench.streams import Stream


def generate(traffic: Dict, seed: int, n: int) -> Stream:
    """``n`` jobs of ``traffic``'s stream for ``seed``."""
    p = traffic["params"]
    day_from, day_to = p["day_hours"]
    per_node = p["procs_per_node"]
    est_lo, est_hi = p["estimate_factor"]
    rng = random.Random(seed)
    t = 0
    rows = []
    for _ in range(int(n)):
        hour = (t // 3600) % 24
        gap = p["day_gap_s"] if day_from <= hour <= day_to \
            else p["night_gap_s"]
        t += int(rng.expovariate(1.0 / gap)) + 1
        procs = rng.choice(p["procs"])
        dur = min(int(rng.lognormvariate(p["runtime_mu"],
                                         p["runtime_sigma"])) + 1,
                  p["max_runtime_s"])
        user = rng.randint(1, p["users"])
        est = min(int(dur * rng.uniform(est_lo, est_hi))
                  + p["estimate_pad_s"], p["max_estimate_s"])
        mem = rng.choice(p["mem_mb"])
        rows.append((t, dur, est, max(1, procs // per_node), user,
                     min(procs, per_node), mem))
    cols = np.asarray(rows, dtype=np.int64).reshape(-1, 7).T
    return Stream(submit=cols[0], duration=cols[1], expected=cols[2],
                  nodes=cols[3], user=cols[4],
                  req={"core": cols[5], "mem": cols[6]})
