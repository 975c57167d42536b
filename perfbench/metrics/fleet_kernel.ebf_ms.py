"""fleet_kernel.ebf_ms: CUDA-event time of the fleet kernel's ebf
launches (``fleet_kernel.ebf`` in the entry's ``instrument``), in
ms, summed over the traced window and divided by its requests (grids)."""


def read(run):
    times = run.kernels.get("fleet_kernel.ebf")
    if not run.requests or not times:
        return None
    return sum(times) / run.requests
