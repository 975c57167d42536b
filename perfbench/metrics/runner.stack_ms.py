"""runner.stack_ms: the host span ``runner.stack`` (the entry's
``instrument``), in ms, summed over the traced window and divided by
its requests (grids)."""


def read(run):
    if not run.requests or "runner.stack" not in run.spans:
        return None
    return run.spans["runner.stack"] * 1e3 / run.requests
