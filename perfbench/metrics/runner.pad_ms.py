"""runner.pad_ms: the program's span ``fleet.pad`` (``SimState.pad_to``
of every sim of a launch, in ``FleetRunner._launch``; the recorder
``repro_torch.telemetry.spans``, on while the profiler captures), in ms,
summed over the traced window and divided by its requests (grids)."""


def read(run):
    try:
        from repro_torch.telemetry import spans
    except ImportError:
        return None
    tot = spans.totals().get("fleet.pad")
    if not run.requests or tot is None:
        return None
    return tot["seconds"] * 1e3 / run.requests
