"""Shared benchmark utilities of the port: the Seth-like system, its
synthetic job stream, the CSV line, and the environment stamp a result
carries.

The Seth stream is the reference's ``benchmarks/common.py`` generator,
draw for draw, yielding the port's ``Job``; ``chip_smoke.py`` and the
port's examples take it from here.
"""
from __future__ import annotations

import os
import platform
import random
import subprocess
from typing import Dict, Iterator

from repro_torch.core.job import Job

# Seth (paper Fig. 7): 120 nodes x 4 cores x 1 GB
SETH = {"groups": {"seth": {"core": 4, "mem": 1024}}, "nodes": {"seth": 120}}

SCALE = float(os.environ.get("BENCH_SCALE", "1.0"))


def scaled(n: int) -> int:
    return max(int(n * SCALE), 10)


def seth_jobs(n: int, seed: int = 0) -> Iterator[Job]:
    """Poisson arrivals with a daily cycle; Seth-plausible job mix.
    Generator (lazy) so the simulator's incremental loading is exercised."""
    rng = random.Random(seed)
    t = 0
    for i in range(n):
        hour = (t // 3600) % 24
        # work-hour arrival bursts push daytime utilization near 1.0 so
        # queues form and dispatchers differentiate (paper Figs. 10-11)
        rate = 55.0 if 8 <= hour <= 18 else 240.0
        t += int(rng.expovariate(1.0 / rate)) + 1
        procs = rng.choice([1, 1, 1, 1, 2, 2, 4, 4, 8, 16, 32])
        nodes = max(1, procs // 4)
        dur = int(rng.lognormvariate(7.2, 1.5)) + 1          # ~22min median
        dur = min(dur, 3 * 86400)
        yield Job(
            id=str(i), user_id=rng.randint(1, 50), submission_time=t,
            duration=dur,
            expected_duration=min(int(dur * rng.uniform(1.0, 4.0)) + 60,
                                  4 * 86400),
            requested_nodes=nodes,
            requested_resources={"core": min(procs, 4),
                                 "mem": rng.choice([128, 256, 512, 1024])},
        )


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    """CSV contract of the reference's benchmarks/run.py:
    name,us_per_call,derived."""
    print(f"{name},{us_per_call:.3f},{derived}")


def bench_metadata() -> Dict[str, object]:
    """Environment stamp for a result: perf numbers are meaningless
    without the torch and CUDA versions and the card they were measured
    on (its name and power limit as ``nvidia-smi`` reports them; None
    where the machine has no ``nvidia-smi``)."""
    import torch

    from repro_torch.utils import cpu_time_s, peak_rss_mb

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    except FileNotFoundError:
        smi = None
    return {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "bench_scale": SCALE,
        # stamped at write time: the process's kernel-tracked memory
        # high-water mark and total CPU seconds, so every result records
        # what the measured run actually cost the machine
        "peak_rss_mb": round(peak_rss_mb(), 1),
        "cpu_time_s": round(cpu_time_s(), 2),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_count": torch.cuda.device_count(),
        "device_kind": (torch.cuda.get_device_name(0)
                        if torch.cuda.is_available() else "cpu"),
        "nvidia_smi": smi,
    }
