"""runner.h2d_ms: the program's counter ``fleet.h2d`` (the host clock
around each field's ``.to(device)`` in ``fleet.engine.stack``; the
recorder ``repro_torch.telemetry.spans``, on while the profiler
captures), in ms, summed over the traced window and divided by its
requests (grids)."""


def read(run):
    try:
        from repro_torch.telemetry import spans
    except ImportError:
        return None
    tot = spans.totals().get("fleet.h2d")
    if not run.requests or tot is None:
        return None
    return tot["seconds"] * 1e3 / run.requests
