"""Process self-measurement without psutil (offline container).

The paper samples memory with psutil every 10 ms; we read the same VmRSS
quantity straight from ``/proc/self/status``.
"""
from __future__ import annotations

import os
import time


# the kernel's per-process status file (a module constant so that tests
# can point it at a file of their own)
STATUS_PATH = "/proc/self/status"


def rss_mb() -> float:
    """Resident set size of this process in MB (VmRSS)."""
    try:
        with open(STATUS_PATH) as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def peak_rss_mb() -> float:
    """Peak resident set size of this process in MB: VmHWM (the
    kernel's high-water mark, so it never misses a spike between
    samples the way polling ``rss_mb`` can), or, where the status file
    has no such line, ``getrusage``'s ``ru_maxrss`` (KB on Linux).
    Raises where neither gives a reading."""
    try:
        with open(STATUS_PATH) as fh:
            for line in fh:
                if line.startswith("VmHWM:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    import resource

    kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    if kb <= 0:
        raise RuntimeError(f"no peak resident set size: {STATUS_PATH} has "
                           f"no VmHWM line and getrusage gives {kb}")
    return kb / 1024.0


def cpu_time_s() -> float:
    """Total CPU seconds consumed by this process so far (user +
    system, all threads — ``os.times``, not the main-thread-only
    ``time.process_time`` split the simulator reports per run)."""
    t = os.times()
    return float(t.user + t.system)


class Timer:
    """Accumulating wall-clock timer with context-manager splits."""

    def __init__(self) -> None:
        self.total = 0.0
        self.count = 0
        self._t0 = 0.0

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.total += time.perf_counter() - self._t0
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0
