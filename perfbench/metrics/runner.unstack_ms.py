"""runner.unstack_ms: the host span ``runner.unstack`` (the entry's
``instrument``), in ms, summed over the traced window and divided by
its requests (grids)."""


def read(run):
    if not run.requests or "runner.unstack" not in run.spans:
        return None
    return run.spans["runner.unstack"] * 1e3 / run.requests
