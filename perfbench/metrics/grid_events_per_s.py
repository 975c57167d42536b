"""grid_events_per_s: simulated events of every grid completed in the
window (the sum of every sim's ``events``) over the window's whole wall,
from its start to the end of the last grid's summaries (host clock)."""


def read(run):
    return run.work / run.window_s if run.requests else None
