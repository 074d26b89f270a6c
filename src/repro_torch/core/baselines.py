"""Baselines the paper evaluates against (§5): brute force, IVF, HNSW,
DiskANN (the port's counterpart of the reference's ``core/baselines.py``).
None of these ship as black boxes here — each is a small, readable
implementation (the paper's complaint about SOTA indexes being opaque is the
reason this module exists at all).

  * BruteForce   — exact scan; ground truth for recall.  A batch scores its
                   ``[B, N]`` distance block on ``device``.
  * IVFIndex     — k-means (Lloyd, assignment on ``device``) + nprobe
                   search (FAISS-style).
  * HNSWLite     — layered navigable-small-world graph, greedy + beam.
  * VamanaLite   — DiskANN's graph: randomized build with alpha-pruning,
                   greedy best-first beam search from a medoid.

The device work is plain PyTorch (``torch_distances``, ``argmin``), as the
reference's is plain jitted JAX: one matrix product each, no hand-written
kernel in either package.  Everything else — the k-means centroid update
and its reseeding, the IVF lists and their search, both graphs — is host
numpy copied from the reference with its rng order, so the lists and the
graphs come out equal to the reference's.

All speak the unified ``Searcher`` API (core/api.py):
``search(q, k, *, b) -> ResultSet`` over one vector [D] or a batch [B, D],
where ``b`` is each index's search-effort knob (IVF nprobe, HNSW ef,
Vamana complexity; BruteForce ignores it).  None of them has native
incremental state, so the ``ResultSet.query`` handle is a ``RestartQuery``
that re-searches with ``emitted + k`` — the paper's Table 4 protocol.
"""
from __future__ import annotations

import heapq
import time

import numpy as np
import torch

from ..device import resolve_device
from .api import RestartQuery, ResultSet, pack_rows
from .distances import np_distances, torch_distances

__all__ = ["BruteForce", "IVFIndex", "HNSWLite", "VamanaLite", "kmeans"]


def _as_result(searcher, q, k, b, rows_d, rows_i, *, single) -> ResultSet:
    d, i = pack_rows(rows_d, rows_i, k)
    query = RestartQuery(searcher, q, k, b=b)
    if single:
        return ResultSet(dists=d[0], ids=i[0], stats=None, query=query)
    return ResultSet(dists=d, ids=i, stats=None, query=query)


def _effort_search(searcher, q, k, b, default_effort) -> ResultSet:
    """Shared single/batch dispatch for the effort-knob baselines: resolve
    ``b`` against the index default, loop rows through ``_search_one``."""
    eff = int(b) if b is not None else default_effort
    q = np.asarray(q, np.float32)
    if q.ndim == 1:
        d, i = searcher._search_one(q, k, eff)
        return _as_result(searcher, q, k, b, [d], [i], single=True)
    rows = [searcher._search_one(row, k, eff) for row in q]
    return _as_result(searcher, q, k, b, [r[0] for r in rows], [r[1] for r in rows], single=False)


# --------------------------------------------------------------- brute force
class BruteForce:
    """Exact scan.  A single query is host numpy (the reference's path); a
    batch computes its ``[B, N]`` distance block on ``device`` against a
    copy of the collection made there once, then argsorts it on the host."""

    def __init__(self, data: np.ndarray, metric: str = "l2", *, device="cuda"):
        self.data = np.asarray(data, np.float32)
        self.metric = metric
        self.device = resolve_device(device)
        self._data_t: torch.Tensor | None = None

    def _device_data(self) -> torch.Tensor:
        if self._data_t is None:
            self._data_t = torch.from_numpy(self.data).to(self.device)
        return self._data_t

    def _search_one(self, q: np.ndarray, k: int):
        d = np_distances(q, self.data, self.metric)
        idx = np.argpartition(d, min(k, len(d) - 1))[:k]
        idx = idx[np.argsort(d[idx])]
        return d[idx], idx

    def search(self, q: np.ndarray, k: int = 100, *, b=None) -> ResultSet:
        q = np.asarray(q, np.float32)
        if q.ndim == 1:
            d, i = self._search_one(q, k)
            return _as_result(self, q, k, b, [d], [i], single=True)
        # batch: one dense device distance block, argsorted per row
        qt = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
        d = torch_distances(qt, self._device_data(), self.metric).cpu().numpy()
        idx = np.argsort(d, axis=-1)[:, :k]
        return _as_result(
            self, q, k, b,
            list(np.take_along_axis(d, idx, axis=-1)), list(idx), single=False,
        )


# ------------------------------------------------------------------- k-means
def kmeans(
    data: np.ndarray,
    n_clusters: int,
    *,
    iters: int = 10,
    metric: str = "l2",
    seed: int = 0,
    batch: int = 65536,
    device="cuda",
    timings: dict | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Lloyd's k-means with the assignment on ``device``.  Returns
    (centroids, assign).

    The collection goes to the device once, in ``batch``-row blocks; each
    iteration uploads the centroids, assigns every row to its nearest
    (``argmin`` of ``torch_distances``, int32) and brings the assignment
    back, then updates the centroids on the host (segment mean) and
    reseeds empty clusters from the same ``np.random.default_rng(seed)``
    stream as the reference.  ``timings``, when given, gets the seconds
    spent in the assignment (``"assign_s"``, device sync included) and in
    the host update (``"update_s"``) added to it."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    data = np.asarray(data, np.float32)
    n = len(data)
    cent = data[rng.choice(n, size=n_clusters, replace=False)].copy()
    blocks = [
        (lo, torch.from_numpy(data[lo : lo + batch]).to(dev)) for lo in range(0, n, batch)
    ]
    assign = np.zeros(n, np.int32)
    t_assign = t_update = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        cj = torch.from_numpy(cent).to(dev)
        for lo, x in blocks:
            a = torch.argmin(torch_distances(x, cj, metric), dim=-1).to(torch.int32)
            assign[lo : lo + len(x)] = a.cpu().numpy()
        t1 = time.perf_counter()
        # host-side centroid update (segment mean)
        sums = np.zeros_like(cent)
        np.add.at(sums, assign, data)
        counts = np.bincount(assign, minlength=n_clusters).astype(np.float32)
        nonempty = counts > 0
        cent[nonempty] = sums[nonempty] / counts[nonempty, None]
        # re-seed empty clusters from random points
        n_empty = int((~nonempty).sum())
        if n_empty:
            cent[~nonempty] = data[rng.choice(n, size=n_empty, replace=False)]
        t_assign += t1 - t0
        t_update += time.perf_counter() - t1
    if timings is not None:
        timings["assign_s"] = timings.get("assign_s", 0.0) + t_assign
        timings["update_s"] = timings.get("update_s", 0.0) + t_update
    return cent, assign


# ----------------------------------------------------------------------- IVF
class IVFIndex:
    """Inverted file: k-means coarse quantizer (assignment on ``device``) +
    nprobe search (host numpy, as the reference)."""

    def __init__(
        self,
        data: np.ndarray,
        n_lists: int,
        *,
        metric: str = "l2",
        train_iters: int = 10,
        seed: int = 0,
        nprobe: int = 8,
        device="cuda",
        timings: dict | None = None,
    ):
        self.data = np.asarray(data, np.float32)
        self.metric = metric
        self.nprobe = nprobe
        self.centroids, assign = kmeans(
            self.data, n_lists, iters=train_iters, metric=metric, seed=seed,
            device=device, timings=timings,
        )
        order = np.argsort(assign, kind="stable")
        bounds = np.searchsorted(assign[order], np.arange(n_lists + 1))
        self.lists = [order[bounds[i] : bounds[i + 1]] for i in range(n_lists)]

    def _search_one(self, q: np.ndarray, k: int, nprobe: int):
        cd = np_distances(q, self.centroids, self.metric)
        probe = np.argsort(cd)[:nprobe]
        cand = np.concatenate([self.lists[p] for p in probe]) if len(probe) else np.zeros(0, np.int64)
        if len(cand) == 0:
            return np.zeros(0, np.float32), np.zeros(0, np.int64)
        d = np_distances(q, self.data[cand], self.metric)
        kk = min(k, len(cand))
        idx = np.argpartition(d, kk - 1)[:kk]
        idx = idx[np.argsort(d[idx])]
        return d[idx], cand[idx]

    def search(self, q: np.ndarray, k: int = 100, *, b=None) -> ResultSet:
        """b = nprobe (coarse lists visited)."""
        return _effort_search(self, q, k, b, self.nprobe)


# ---------------------------------------------------------------------- HNSW
class HNSWLite:
    """Hierarchical navigable small world (Malkov & Yashunin), readable form.

    Build: insert points one at a time; each gets a geometric random level;
    greedy-descend from the entry point, then at each level run a beam
    (ef_construction) and connect to the M closest results (simple pruning).
    Host numpy in both packages: no device work.
    """

    def __init__(
        self,
        data: np.ndarray,
        *,
        M: int = 16,
        ef_construction: int = 64,
        metric: str = "l2",
        seed: int = 0,
        ef: int = 100,
    ):
        self.data = np.asarray(data, np.float32)
        self.metric = metric
        self.ef = ef
        self.M = M
        self.ml = 1.0 / np.log(M)
        rng = np.random.default_rng(seed)
        n = len(self.data)
        self.levels = np.minimum(
            (-np.log(rng.uniform(1e-12, 1.0, n)) * self.ml).astype(np.int64), 8
        )
        self.max_level = int(self.levels.max()) if n else 0
        # adjacency: per level, dict node -> list of neighbours
        self.graph: list[dict[int, list[int]]] = [dict() for _ in range(self.max_level + 1)]
        self.entry = 0
        for i in range(n):
            self._insert(i, ef_construction)

    def _dist(self, a: int, q: np.ndarray) -> float:
        return float(np_distances(q, self.data[a][None], self.metric)[0])

    def _search_layer(self, q: np.ndarray, entry: int, ef: int, level: int):
        g = self.graph[level]
        dist0 = self._dist(entry, q)
        visited = {entry}
        cand = [(dist0, entry)]                 # min-heap
        best = [(-dist0, entry)]                # max-heap of current top-ef
        while cand:
            d, u = heapq.heappop(cand)
            if d > -best[0][0]:
                break
            for v in g.get(u, ()):  # explore neighbours
                if v in visited:
                    continue
                visited.add(v)
                dv = self._dist(v, q)
                if dv < -best[0][0] or len(best) < ef:
                    heapq.heappush(cand, (dv, v))
                    heapq.heappush(best, (-dv, v))
                    if len(best) > ef:
                        heapq.heappop(best)
        return sorted((-d, v) for d, v in best)

    def _insert(self, i: int, ef_c: int) -> None:
        lvl = int(self.levels[i])
        if i == 0:
            for lc in range(lvl + 1):
                self.graph[lc][i] = []
            self.entry = i
            self.entry_level = lvl
            return
        q = self.data[i]
        ep = self.entry
        for lc in range(self.max_level, lvl, -1):
            if self.graph[lc]:
                res = self._search_layer(q, ep, 1, lc) if ep in self.graph[lc] else None
                if res:
                    ep = res[0][1]
        for lc in range(min(lvl, self.max_level), -1, -1):
            if ep not in self.graph[lc]:
                self.graph[lc][i] = []
                continue
            res = self._search_layer(q, ep, ef_c, lc)
            neigh = [v for _, v in res[: self.M]]
            self.graph[lc][i] = list(neigh)
            for v in neigh:
                lst = self.graph[lc].setdefault(v, [])
                lst.append(i)
                if len(lst) > 2 * self.M:  # prune by distance to v
                    dv = np_distances(self.data[v], self.data[lst], self.metric)
                    keep = np.argsort(dv)[: self.M]
                    self.graph[lc][v] = [lst[j] for j in keep]
            ep = res[0][1] if res else ep
        if lvl > getattr(self, "entry_level", 0):
            self.entry = i
            self.entry_level = lvl

    def _search_one(self, q: np.ndarray, k: int, ef: int):
        ep = self.entry
        for lc in range(self.max_level, 0, -1):
            if self.graph[lc] and ep in self.graph[lc]:
                ep = self._search_layer(q, ep, 1, lc)[0][1]
        res = self._search_layer(q, ep, max(ef, k), 0)[:k]
        return (
            np.asarray([d for d, _ in res], np.float32),
            np.asarray([v for _, v in res], np.int64),
        )

    def search(self, q: np.ndarray, k: int = 100, *, b=None) -> ResultSet:
        """b = ef (beam width at layer 0)."""
        return _effort_search(self, q, k, b, self.ef)


# -------------------------------------------------------------------- Vamana
class VamanaLite:
    """DiskANN's Vamana graph (readable form): random init, two passes of
    greedy-search + alpha-pruned reconnection; search = best-first beam from
    the medoid ("complexity" = beam width, as DiskANN calls it).  Host numpy
    in both packages: no device work."""

    def __init__(
        self,
        data: np.ndarray,
        *,
        R: int = 24,
        L_build: int = 64,
        alpha: float = 1.2,
        metric: str = "l2",
        seed: int = 0,
        complexity: int = 100,
    ):
        self.data = np.asarray(data, np.float32)
        self.metric = metric
        self.complexity = complexity
        self.R = R
        n = len(self.data)
        rng = np.random.default_rng(seed)
        self.nbrs = [list(rng.choice(n, size=min(R, n - 1), replace=False)) for _ in range(n)]
        self.medoid = int(
            np.argmin(np_distances(self.data.mean(0), self.data, metric))
        )
        for _pass in range(2):
            for i in rng.permutation(n):
                _, visited = self._greedy(self.data[i], L_build, return_visited=True)
                self.nbrs[i] = self._robust_prune(i, visited, alpha)
                for j in self.nbrs[i]:
                    if i not in self.nbrs[j]:
                        self.nbrs[j].append(i)
                        if len(self.nbrs[j]) > R:
                            self.nbrs[j] = self._robust_prune(j, self.nbrs[j], alpha)

    def _robust_prune(self, i: int, cand: list[int], alpha: float) -> list[int]:
        cand = [c for c in dict.fromkeys(cand) if c != i]
        if not cand:
            return []
        d_i = np_distances(self.data[i], self.data[cand], self.metric)
        order = np.argsort(d_i)
        chosen: list[int] = []
        for oi in order:
            c = cand[oi]
            if len(chosen) >= self.R:
                break
            ok = True
            if chosen:
                d_cc = np_distances(self.data[c], self.data[chosen], self.metric)
                if np.any(alpha * d_cc < d_i[oi]):
                    ok = False
            if ok:
                chosen.append(c)
        return chosen

    def _greedy(self, q: np.ndarray, L: int, *, return_visited: bool = False):
        start = self.medoid
        d0 = float(np_distances(q, self.data[start][None], self.metric)[0])
        best = [(d0, start)]
        visited = {start}
        frontier = [(d0, start)]
        while frontier:
            d, u = heapq.heappop(frontier)
            if d > best[-1][0] and len(best) >= L:
                break
            new = [v for v in self.nbrs[u] if v not in visited]
            if not new:
                continue
            visited.update(new)
            dv = np_distances(q, self.data[new], self.metric)
            for v, dvv in zip(new, dv):
                heapq.heappush(frontier, (float(dvv), v))
                best.append((float(dvv), v))
            best = sorted(best)[:L]
        if return_visited:
            return best, list(visited)
        return best

    def _search_one(self, q: np.ndarray, k: int, complexity: int):
        best = self._greedy(q, max(complexity, k))
        best = best[:k]
        return (
            np.asarray([d for d, _ in best], np.float32),
            np.asarray([v for _, v in best], np.int64),
        )

    def search(self, q: np.ndarray, k: int = 100, *, b=None) -> ResultSet:
        """b = complexity (DiskANN's beam width)."""
        return _effort_search(self, q, k, b, self.complexity)
