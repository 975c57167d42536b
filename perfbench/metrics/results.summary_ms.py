"""results.summary_ms: the host span ``results.summary`` (the entry's
``instrument``), in ms, summed over the traced window and divided by
its requests (grids)."""


def read(run):
    if not run.requests or "results.summary" not in run.spans:
        return None
    return run.spans["results.summary"] * 1e3 / run.requests
