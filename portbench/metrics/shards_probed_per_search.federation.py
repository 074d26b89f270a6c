"""Shards a search of the window probed, on average: the size of the
split of ``b`` that the federation recorded with each query row
(``FederatedQuery.allocation``)."""


def read(run):
    sizes = [len(r) for u in run.units for r in (u.routes or []) if r is not None]
    return sum(sizes) / len(sizes) if sizes else None
