"""The reference traversal engine of the port: a copy of the JAX package's
``core/legacy.py`` (host numpy and ``heapq``; no device work).

The paper's Algorithms 1-3 as first implemented: a ``heapq`` of
``(d, tie, is_leaf, level, node)`` tuples for T, an unbounded
``[(d, item_id)]`` list for I re-sorted on every increment, and per-item
Python conversions throughout.  It is the port's own parity oracle
(``ECPIndex(engine="legacy")``): the flat engine must return
bit-identical ``(dists, ids)``, and so must the reference's legacy engine
on the same files.

Functions take the ``ECPIndex`` as an explicit parameter (node IO, cache
and prefetch plumbing stay shared); only the per-query state and the
traversal inner loop live here.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field

import numpy as np

from .api import SearchStats
from .distances import np_distances

__all__ = ["LegacyQueryState"]


@dataclass
class LegacyQueryState:
    """Persistent per-query state (paper §4.3): Q.q, Q.T, Q.I."""

    q: np.ndarray
    b: int                                  # configured base leaf budget
    mx_inc: int
    exclude: set = field(default_factory=set)
    T: list = field(default_factory=list)   # heap of (d, tie, is_leaf, level, node)
    I: list = field(default_factory=list)   # sorted [(d, item_id)]
    started: bool = False
    increments: int = 0
    emitted: int = 0
    probe_m: int = 1                        # frontier pops per traversal step
    b_cur: int = 0                          # transient budget: reset to b at the
                                            # start of every increment, doubled
                                            # in place of the old ``qs.b *= 2``
    seen: set = field(default_factory=set)  # ids ever appended to I (spill dedup)
    stats: SearchStats = field(default_factory=SearchStats)
    _tie: "itertools.count" = field(default_factory=itertools.count)


# ----------------------------------------------------------- Algorithm 2
def next_items(index, qs: LegacyQueryState, k: int) -> tuple[list, list]:
    cnt = min(len(qs.I), k)
    if cnt < k and qs.T:
        incremental_search(index, qs, k)
        cnt = min(len(qs.I), k)
    out, qs.I = qs.I[:cnt], qs.I[cnt:]
    qs.emitted += len(out)
    return [x[0] for x in out], [x[1] for x in out]


# ----------------------------------------------------------- Algorithm 3
def incremental_search(index, qs: LegacyQueryState, k: int) -> None:
    info = index.info
    metric = info.metric
    leaf_cnt = 0
    qs.b_cur = qs.b  # each increment starts from the configured budget
    dedup = info.spill_s > 0
    loads_before = index.load_node_count
    io_before = index.store.io.snapshot()

    if not qs.started:
        qs.started = True
        d = np_distances(qs.q, index.root_emb, metric)
        qs.stats.distance_calcs += len(index.root_emb)
        is_leaf = 1 if info.levels == 1 else 0
        for c, dist in zip(index.root_ids, d):
            heapq.heappush(qs.T, (float(dist), next(qs._tie), is_leaf, 1, int(c)))

    # Each step pops a probe group — the top-min(probe_m, |T|) frontier
    # entries taken BEFORE any of them is expanded (children pushed by the
    # group land in the next group, exactly one batch-engine round).
    # Budget/termination checks stay inline per leaf but only break at the
    # group boundary, so a group may stage up to probe_m - 1 leaves past
    # the stopping point — that overshoot is the recall widening.
    # probe_m=1 is today's loop.
    while qs.T:
        stop = False
        group = [
            heapq.heappop(qs.T) for _ in range(min(qs.probe_m, len(qs.T)))
        ]
        for dist, _, is_leaf, level, node in group:
            qs.stats.nodes_opened += 1
            emb, ids = index.get_node(level, node)
            if len(ids) == 0:
                continue
            d = np_distances(qs.q, emb, metric)
            qs.stats.distance_calcs += len(ids)
            if is_leaf:
                qs.stats.leaves_opened += 1
                tomb = index._tombstones  # lifecycle deletes filter at scan time
                for c, cd in zip(ids, d):
                    c = int(c)
                    if c in qs.exclude or c in tomb:
                        continue
                    if dedup:
                        if c in qs.seen:
                            continue
                        qs.seen.add(c)
                    qs.I.append((float(cd), c))
                leaf_cnt += 1
            else:
                next_is_leaf = 1 if (level + 1) == info.levels else 0
                for c, cd in zip(ids, d):
                    heapq.heappush(
                        qs.T, (float(cd), next(qs._tie), next_is_leaf, level + 1, int(c))
                    )
                if index._store_prefetch is not None:
                    order = np.argsort(d)[: index.prefetch_fanout]
                    want = [
                        (level + 1, int(ids[j]))
                        for j in order
                        if not index.cache.contains(index._key(level + 1, int(ids[j])))
                    ]
                    if want:
                        index._store_prefetch(want, on_node=index._on_prefetched)
            if is_leaf and leaf_cnt >= qs.b_cur:
                if len(qs.I) >= k:
                    stop = True
                elif qs.mx_inc == -1 or qs.increments < qs.mx_inc:
                    qs.increments += 1
                    qs.stats.increments += 1
                    qs.b_cur *= 2
                else:
                    stop = True
        if stop:
            break
    qs.stats.node_loads += index.load_node_count - loads_before
    qs.stats.io.add(index.store.io.delta(io_before))
    qs.I.sort(key=lambda t: t[0])


# -------------------------------------------------------------- persistence
def export_state(qs: LegacyQueryState) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(item_dists, item_ids, frontier_rows) in the §6.2 on-disk schema."""
    if qs.I:
        d = np.asarray([x[0] for x in qs.I], np.float32)
        i = np.asarray([x[1] for x in qs.I], np.int64)
    else:
        d = np.zeros((0,), np.float32)
        i = np.zeros((0,), np.int64)
    if qs.T:
        t = np.asarray([(e[0], e[2], e[3], e[4]) for e in qs.T], np.float64)
    else:
        t = np.zeros((0, 4), np.float64)
    return d, i, t


def load_state(
    q: np.ndarray,
    attrs: dict,
    item_d: np.ndarray,
    item_i: np.ndarray,
    frontier_rows: np.ndarray,
    seen_ids: np.ndarray | None = None,
) -> LegacyQueryState:
    qs = LegacyQueryState(
        q=q,
        b=int(attrs["b"]),
        mx_inc=int(attrs["mx_inc"]),
        exclude=set(attrs.get("exclude", [])),
        probe_m=int(attrs.get("probe_m", 1)),
    )
    qs.increments = int(attrs["increments"])
    qs.emitted = int(attrs["emitted"])
    qs.started = bool(attrs["started"])
    qs.I = [(float(x), int(y)) for x, y in zip(item_d, item_i)]
    if seen_ids is not None:
        qs.seen = {int(x) for x in seen_ids}
    for row in frontier_rows:
        heapq.heappush(
            qs.T, (float(row[0]), next(qs._tie), int(row[1]), int(row[2]), int(row[3]))
        )
    return qs
