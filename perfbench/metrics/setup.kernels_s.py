"""setup.kernels_s: the program's set-up spans ``kernels.build``
(``build_all``: the check for, and any ``nvcc`` run of, a library) and
``kernels.load`` (a library's first load; the recorder
``repro_torch.telemetry.spans`` keeps set-up spans with tracing off), in
s, summed over the run's set-up.  No kernel library loads on the CPU."""


def read(run):
    try:
        from repro_torch.telemetry import spans
    except ImportError:
        return None
    tot = spans.totals()
    found = [tot[k]["seconds"] for k in ("kernels.build", "kernels.load")
             if k in tot]
    return sum(found) if found else None
