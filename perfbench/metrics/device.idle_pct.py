"""device.idle_pct: share of the traced window in which the card ran
neither a kernel nor a copy: from the profiler's trace, or from the
CUDA events' kernel intervals where the profiler's time of the
entry's kernels disagrees with them (the run's earlier line says which
source it used)."""


def read(run):
    busy, window = run.device.get("busy_s"), run.device.get("window_s")
    if not window or busy is None or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
