"""Flat-array traversal structures for the file-mode search engine.

The paper's Algorithm 3 keeps two per-query collections that used to be
plain Python objects — a ``heapq`` of ``(d, tie, is_leaf, level, node)``
tuples and an unbounded ``[(d, item_id)]`` list fully re-sorted on every
increment.  At benchmark scale most of eCP-FS's measured latency was this
interpreter overhead, not file I/O.  This module replaces both with flat
numpy columns and batch operations while preserving the *exact* ordering
semantics of the tuple code (ties included), so results stay bit-identical:

``Frontier``
    The priority queue T.  Entries live in preallocated, growable
    ``float32``/``int32`` columns (``d``/``tie``/``leaf``/``level``/
    ``node``).  A whole node expansion is pushed in ONE call
    (``push_batch``): the batch is stably argsorted by distance — which,
    because ties are assigned in insertion order, equals sorting by
    ``(d, tie)`` — and appended to the arena as a sorted run.  Pops merge
    the runs through a tiny ``heapq`` of run heads keyed by ``(d, tie)``;
    the global pop order is therefore exactly the tuple heap's
    ``(d, tie)`` lexicographic order, at one heap operation per *node*
    expansion batch instead of one per child.

``CandidateBuffer``
    The result list I.  Scanned leaf items are appended as whole arrays
    (``stage``); ``commit()`` performs one C-level stable argsort over
    ``[sorted live region + staged batches]`` — the exact permutation the
    old code produced by list-append + repeated stable ``list.sort``.
    Emission advances a start offset instead of reslicing the list.

Both structures serialize back to the on-disk query-state schema of
paper §6.2 (``export_*``), so ``Query.save()``/``load_query`` and
``next(k)`` continuation are unchanged.
"""
from __future__ import annotations

import heapq

import numpy as np

__all__ = ["Frontier", "CandidateBuffer"]


class Frontier:
    """Flat-array priority queue over index-tree nodes.

    Pop order is lexicographic ``(d, tie)`` where ``tie`` is the global
    insertion counter — bit-identical to a ``heapq`` of
    ``(d, tie, is_leaf, level, node)`` tuples (``tie`` is unique, so the
    remaining tuple fields never participate in comparisons).
    """

    __slots__ = ("d", "tie", "leaf", "level", "node", "size", "_heads", "_n", "_next_tie")

    def __init__(self, capacity: int = 256):
        capacity = max(1, int(capacity))
        self.d = np.empty(capacity, np.float32)
        self.tie = np.empty(capacity, np.int64)
        self.leaf = np.empty(capacity, np.uint8)
        self.level = np.empty(capacity, np.int32)
        self.node = np.empty(capacity, np.int32)
        self.size = 0          # arena watermark (includes consumed rows)
        self._heads = []       # heapq of (d, tie, pos, end): sorted-run heads
        self._n = 0            # live (un-popped) entries
        self._next_tie = 0

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    # ------------------------------------------------------------------ grow
    def _ensure(self, extra: int) -> None:
        need = self.size + extra
        cap = len(self.d)
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        for name in ("d", "tie", "leaf", "level", "node"):
            old = getattr(self, name)
            new = np.empty(cap, old.dtype)
            new[: self.size] = old[: self.size]
            setattr(self, name, new)

    # ------------------------------------------------------------------ push
    def push_batch(self, d, nodes, is_leaf, level) -> None:
        """Push one expansion batch: ``d[i]`` is the distance of child
        ``nodes[i]``; ties are assigned in ``nodes`` order (exactly the old
        per-child ``heappush`` loop).  ``is_leaf``/``level`` are scalars for
        a node expansion or per-entry arrays (state rehydration)."""
        d = np.asarray(d, np.float32)
        w = len(d)
        if w == 0:
            return
        self._ensure(w)
        # stable sort by d == sort by (d, tie): ties keep insertion order
        order = np.argsort(d, kind="stable")
        s, e = self.size, self.size + w
        self.d[s:e] = d[order]
        self.tie[s:e] = self._next_tie + order
        nodes = np.asarray(nodes)
        self.node[s:e] = nodes[order]
        if np.ndim(is_leaf) == 0:
            self.leaf[s:e] = 1 if is_leaf else 0
        else:
            self.leaf[s:e] = np.asarray(is_leaf, np.uint8)[order]
        if np.ndim(level) == 0:
            self.level[s:e] = int(level)
        else:
            self.level[s:e] = np.asarray(level, np.int32)[order]
        self._next_tie += w
        self.size = e
        self._n += w
        heapq.heappush(self._heads, (float(self.d[s]), int(self.tie[s]), s, e))

    # ------------------------------------------------------------------- pop
    def pop(self) -> tuple[float, int, int, int]:
        """Pop the globally best entry -> ``(d, is_leaf, level, node)``."""
        if not self._n:
            raise IndexError("pop from an empty Frontier")
        d0, _, pos, end = heapq.heappop(self._heads)
        out = (d0, int(self.leaf[pos]), int(self.level[pos]), int(self.node[pos]))
        nxt = pos + 1
        if nxt < end:
            heapq.heappush(
                self._heads, (float(self.d[nxt]), int(self.tie[nxt]), nxt, end)
            )
        self._n -= 1
        return out

    def peek(self) -> tuple[float, int, int, int]:
        if not self._n:
            raise IndexError("peek on an empty Frontier")
        d0, _, pos, _ = self._heads[0]
        return (d0, int(self.leaf[pos]), int(self.level[pos]), int(self.node[pos]))

    # ----------------------------------------------------------- persistence
    def export_rows(self) -> np.ndarray:
        """Live entries as the saved-frontier array ``[n, 4]`` float64 of
        ``(d, is_leaf, level, node)`` — the §6.2 on-disk schema (row order
        is not significant; rehydration re-sorts by distance)."""
        rows = np.zeros((self._n, 4), np.float64)
        at = 0
        for _, _, pos, end in sorted(self._heads, key=lambda h: h[2]):
            m = end - pos
            rows[at : at + m, 0] = self.d[pos:end]
            rows[at : at + m, 1] = self.leaf[pos:end]
            rows[at : at + m, 2] = self.level[pos:end]
            rows[at : at + m, 3] = self.node[pos:end]
            at += m
        return rows

    @classmethod
    def from_rows(cls, rows: np.ndarray) -> "Frontier":
        """Rehydrate a saved frontier.  All rows enter as one batch with
        ties in file order — the same order the old loader's sequential
        ``heappush`` produced."""
        f = cls(capacity=max(1, len(rows)))
        if len(rows):
            f.push_batch(
                rows[:, 0],
                rows[:, 3].astype(np.int32),
                rows[:, 1].astype(np.uint8),
                rows[:, 2].astype(np.int32),
            )
        return f


class CandidateBuffer:
    """Sorted candidate items (the paper's I) as flat numpy columns.

    ``stage(d, ids)`` parks scanned-leaf arrays without per-item work;
    ``commit()`` merges them into the sorted live region with one stable
    argsort — the exact order of the old list-append + stable ``sort``:
    by distance, ties by scan order, previously-merged items first.
    ``take(k)`` emits the k best by advancing a start offset.

    ``dedup=True`` (spill-built indexes, where a vector may be replicated
    into several leaves) drops every staged id that was already committed
    or emitted, keeping the first occurrence, so ``take``/``next(k)``
    never yields an id twice.  Replica distances are bitwise identical —
    each distance is a dot product over that row's bytes alone — so which
    copy survives does not affect the emitted (d, id) values.
    """

    __slots__ = ("d", "i", "start", "_staged_d", "_staged_i", "_staged_n", "dedup", "_seen")

    def __init__(self, dedup: bool = False):
        self.d = np.empty(0, np.float32)
        self.i = np.empty(0, np.int64)
        self.start = 0
        self._staged_d: list[np.ndarray] = []
        self._staged_i: list[np.ndarray] = []
        self._staged_n = 0
        self.dedup = bool(dedup)
        self._seen: set[int] = set()

    def __len__(self) -> int:
        return (len(self.d) - self.start) + self._staged_n

    def stage(self, d: np.ndarray, ids: np.ndarray) -> None:
        """Park one scanned leaf's (already filtered) items for the next
        ``commit``; ``d``/``ids`` arrive in within-leaf scan order."""
        if len(d) == 0:
            return
        self._staged_d.append(np.asarray(d, np.float32))
        self._staged_i.append(np.asarray(ids, np.int64))
        self._staged_n += len(d)

    def commit(self) -> None:
        """Merge staged batches into the sorted live region (one stable
        argsort, C speed — replaces the old full ``list.sort`` per
        increment)."""
        if not self._staged_n:
            return
        if self.dedup:
            self._drop_seen()
            if not self._staged_n:
                return
        live_d = self.d[self.start :]
        live_i = self.i[self.start :]
        all_d = np.concatenate([live_d, *self._staged_d])
        all_i = np.concatenate([live_i, *self._staged_i])
        order = np.argsort(all_d, kind="stable")
        self.d = all_d[order]
        self.i = all_i[order]
        self.start = 0
        self._staged_d.clear()
        self._staged_i.clear()
        self._staged_n = 0

    def _drop_seen(self) -> None:
        """Filter staged batches against every id already committed (live
        or emitted), first occurrence wins; batches stay in scan order."""
        seen = self._seen
        kept_d: list[np.ndarray] = []
        kept_i: list[np.ndarray] = []
        n = 0
        for d_b, i_b in zip(self._staged_d, self._staged_i):
            keep = np.ones(len(i_b), bool)
            for p, x in enumerate(i_b):
                xi = int(x)
                if xi in seen:
                    keep[p] = False
                else:
                    seen.add(xi)
            if not keep.all():
                d_b, i_b = d_b[keep], i_b[keep]
            if len(i_b):
                kept_d.append(d_b)
                kept_i.append(i_b)
                n += len(i_b)
        self._staged_d = kept_d
        self._staged_i = kept_i
        self._staged_n = n

    def seed_seen(self, ids) -> None:
        """Mark ``ids`` as already seen (query-state rehydration)."""
        self._seen.update(int(x) for x in np.asarray(ids).ravel())

    def export_seen(self) -> np.ndarray:
        """The seen-id set as a sorted int64 array (persistence)."""
        return np.asarray(sorted(self._seen), np.int64)

    def take(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Emit (and consume) the best ``k`` committed items."""
        n = min(k, len(self.d) - self.start)
        n = max(n, 0)
        s = self.start
        self.start = s + n
        return self.d[s : s + n], self.i[s : s + n]

    # ----------------------------------------------------------- persistence
    def export_items(self) -> tuple[np.ndarray, np.ndarray]:
        """Remaining committed items (the saved ``item_dists``/``item_ids``
        arrays).  Call ``commit()`` first if anything is staged."""
        if self._staged_n:
            self.commit()
        return self.d[self.start :].copy(), self.i[self.start :].copy()

    @classmethod
    def from_items(cls, d: np.ndarray, ids: np.ndarray) -> "CandidateBuffer":
        buf = cls()
        buf.d = np.asarray(d, np.float32).copy()
        buf.i = np.asarray(ids, np.int64).copy()
        return buf
