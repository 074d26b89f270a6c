"""Bytes the store read in the window (``IOStats.bytes_read`` of the
index's store, summed over every worker) per search."""


def read(run):
    if "store_bytes_read" not in run.counters or not run.searches:
        return None
    return run.counters["store_bytes_read"] / run.searches
