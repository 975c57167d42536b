"""runner.d2h_ms: the program's counter ``fleet.d2h`` (the host clock
around each field's ``.cpu()`` in ``fleet.engine.unstack``, after the
batch's stream has been waited for; the recorder
``repro_torch.telemetry.spans``, on while the profiler captures), in ms,
summed over the traced window and divided by its requests (grids)."""


def read(run):
    try:
        from repro_torch.telemetry import spans
    except ImportError:
        return None
    tot = spans.totals().get("fleet.d2h")
    if not run.requests or tot is None:
        return None
    return tot["seconds"] * 1e3 / run.requests
