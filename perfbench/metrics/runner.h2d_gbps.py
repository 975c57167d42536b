"""runner.h2d_gbps: the program's counter ``fleet.h2d`` (each field's
``.to(device)`` in ``fleet.engine.stack``; the recorder
``repro_torch.telemetry.spans``, on while the profiler captures): its
bytes over its seconds, in GB/s (1e9 bytes), over the traced window."""


def read(run):
    try:
        from repro_torch.telemetry import spans
    except ImportError:
        return None
    tot = spans.totals().get("fleet.h2d")
    if tot is None or tot["seconds"] <= 0:
        return None
    return tot["bytes"] / tot["seconds"] * 1e-9
