"""fleet_kernel.blocking_ms: CUDA-event time of the fleet kernel's blocking
launches (``fleet_kernel.blocking`` in the entry's ``instrument``), in
ms, summed over the traced window and divided by its requests (grids)."""


def read(run):
    times = run.kernels.get("fleet_kernel.blocking")
    if not run.requests or not times:
        return None
    return sum(times) / run.requests
