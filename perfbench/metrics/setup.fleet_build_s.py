"""setup.fleet_build_s: the program's set-up span ``fleet.build``
(``FleetRunner.build``, one a stream; the recorder
``repro_torch.telemetry.spans`` keeps set-up spans with tracing off), in
s, summed over the run's set-up."""


def read(run):
    try:
        from repro_torch.telemetry import spans
    except ImportError:
        return None
    tot = spans.totals().get("fleet.build")
    return None if tot is None else tot["seconds"]
