"""Device time of every operation in the traced window, per request of
the cell (a batch of query rows, its search and its continuations)."""


def read(run):
    if run.trace is None or not run.searches:
        return None
    seconds, records = run.trace.device_s()
    if not records:
        return None
    return 1e3 * seconds / run.searches
