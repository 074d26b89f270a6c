"""Share of the node cache's lookups in the window that hit
(``NodeCache.hits`` / ``.misses``), in percent."""


def read(run):
    hits, misses = run.counters.get("cache_hits", 0), run.counters.get("cache_misses", 0)
    if hits + misses == 0:
        return None
    return 100.0 * hits / (hits + misses)
