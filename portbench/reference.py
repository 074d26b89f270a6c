"""The plain reference of eCP's semantics (paper §3-4), in PyTorch and numpy.

It imports nothing of the program.  It works out again what a build
derives from the collection (the index's shape, the leader draw, each
level's nearest-parent assignment, the items' greedy descent) and what a
search returns at a given ``b``: the best-first traversal of file mode
(one priority queue over every level; after ``b`` leaves stop if ``k``
items are staged, else double ``b``, at most ``mx_inc`` times), and the
level-synchronous beam of packed mode (top ``max(b, 8)`` nodes a level,
every leaf under the last internal level ranked, the nearest ``b``
scanned).  Items of the opened leaves are ranked by their distance; pages
of ``k`` are consecutive slices of that ranking.

A configuration with ``shards`` is a federation (``Federation``): the
collection cut into contiguous slices, each built as an index of its own
under the same settings (its own leader draw) and holding global ids.  A
search routes by the ``b`` router centroids (every shard's level-1
leaders) nearest the query, each a vote for its shard; ``allocate``
splits ``b`` over the most-voted shards in proportion to their votes; each
probed shard is searched at its share, and the pages merge the shards'
emissions of ``k`` in distance order, a shard asked for its next ``k``
once its last emission is used up (a best-first shard then opens more
leaves when fewer than ``k`` of its staged items are left).

``dtype`` is the precision of every distance: float64 for the reference;
``TF32`` for the control (unit rows rounded to TF32's 10 mantissa bits,
products summed in float32, as TF32 tensor cores take a float32 product),
the precision just below the configuration's float32; bfloat16 for a
coarser control.
"""
from __future__ import annotations

import functools
import heapq
import math
from dataclasses import dataclass

import numpy as np
import torch


def derive_shape(n_items: int, cluster_cap: int, levels: int) -> tuple[int, list[int]]:
    """Paper §3: l = ceil(N / C) leaders, fanout w = ceil(l^(1/L)); level i
    holds min(l, w^i) nodes and the last level all l leaves."""
    n_leaders = max(1, math.ceil(n_items / max(1, cluster_cap)))
    fanout = max(1, math.ceil(n_leaders ** (1.0 / levels)))
    nodes = [min(n_leaders, fanout**i) for i in range(1, levels + 1)]
    nodes[-1] = n_leaders
    return n_leaders, nodes


def leader_draw(seed: int, n_items: int, n_leaders: int) -> np.ndarray:
    """The leaders: a uniform draw without replacement, in draw order;
    level i's nodes are the first ``nodes[i]`` of them."""
    return np.random.default_rng(seed).choice(n_items, size=n_leaders, replace=False)


TF32 = "tfloat32"


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (10 mantissa
    bits, ties to even)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


def unit(x: torch.Tensor, dtype) -> torch.Tensor:
    """Rows scaled to norm 1 in ``dtype`` (``TF32``: in float32, then
    rounded to TF32)."""
    if dtype == TF32:
        return tf32(unit(x, torch.float32))
    x = x.to(dtype)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def cos_dist(qn: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """Cosine distances of unit rows: [B, D] x [N, D] -> [B, N] float64."""
    return (1.0 - qn @ xn.T).to(torch.float64)


@dataclass
class Index:
    """An index's structure: leader item ids, each internal level's
    children lists (node -> node indices of the next level) and each
    leaf's items."""

    leaders: np.ndarray             # [l] item ids
    nodes: list[int]                # nodes per level, levels 1..L
    children: list[list[np.ndarray]]  # children[i][j]: level i+1 node j -> level i+2 nodes
    members: list[np.ndarray]       # members[j]: item ids of leaf j

    @property
    def levels(self) -> int:
        return len(self.nodes)


def assign_children(lead: torch.Tensor, nodes: list[int]) -> list[list[np.ndarray]]:
    """Each level's nodes under their nearest parent (unit leader rows in
    the computing dtype; first index on ties)."""
    out = []
    for i in range(1, len(nodes)):
        d = cos_dist(lead[: nodes[i]], lead[: nodes[i - 1]])
        out.append(group(torch.argmin(d, dim=1).cpu().numpy(), nodes[i - 1]))
    return out


def group(owner: np.ndarray, n: int) -> list[np.ndarray]:
    """The indices that each of ``n`` owners owns, in index order."""
    order = np.argsort(owner, kind="stable")
    bounds = np.searchsorted(owner[order], np.arange(n + 1))
    return [order[bounds[j] : bounds[j + 1]] for j in range(n)]


def child_mask(children: list[np.ndarray], n_children: int, device) -> torch.Tensor:
    m = torch.zeros((len(children), n_children), dtype=torch.bool, device=device)
    for j, c in enumerate(children):
        m[j, torch.as_tensor(c, dtype=torch.int64, device=device)] = True
    return m


def descend(d: torch.Tensor, nodes: list[int], masks: list[torch.Tensor]) -> torch.Tensor:
    """Greedy descent of rows whose distances to every leader are ``d``
    [B, l]: the nearest level-1 node, then the nearest child at each
    level.  -> [B] leaf indices."""
    node = torch.argmin(d[:, : nodes[0]], dim=1)
    for i, m in enumerate(masks):
        node = torch.argmin(torch.where(m[node], d[:, : nodes[i + 1]], math.inf), dim=1)
    return node


def build(data: torch.Tensor, cfg: dict, dtype, rows: int = 1 << 16) -> Index:
    """The index a build derives from ``data`` [N, D] (storage dtype, on
    the computing device), every distance in ``dtype``."""
    n = data.shape[0]
    n_leaders, nodes = derive_shape(n, int(cfg["cluster_cap"]), int(cfg["levels"]))
    pos = leader_draw(int(cfg["build_seed"]), n, n_leaders)
    lead = unit(data[torch.as_tensor(pos, device=data.device)], dtype)
    children = assign_children(lead, nodes)
    masks = [child_mask(c, nodes[i + 1], data.device) for i, c in enumerate(children)]
    leaf = torch.cat([descend(cos_dist(unit(data[lo : lo + rows], dtype), lead), nodes, masks)
                      for lo in range(0, n, rows)]).cpu().numpy()
    return Index(pos.astype(np.int64), nodes, children, group(leaf, n_leaders))


def best_first(d_lead: np.ndarray, index: Index, b: int, k: int, mx_inc: int) -> list[int]:
    """The leaves file mode opens for one query, in order.  ``d_lead``:
    the query's distances to every leader (level i's node j is leader j)."""
    L = index.levels
    heap = [(float(d_lead[j]), j, 1, j) for j in range(index.nodes[0])]
    heapq.heapify(heap)
    seq = len(heap)
    opened, staged, budget, inc = [], 0, b, 0
    while heap:
        _, _, level, node = heapq.heappop(heap)
        if level < L:
            for c in index.children[level - 1][node]:
                heapq.heappush(heap, (float(d_lead[c]), seq, level + 1, int(c)))
                seq += 1
            continue
        opened.append(node)
        staged += len(index.members[node])
        if len(opened) >= budget:
            if staged >= k:
                break
            if mx_inc == -1 or inc < mx_inc:
                inc += 1
                budget *= 2
            else:
                break
    return opened


def beam(d_lead: torch.Tensor, index: Index, b: int) -> torch.Tensor:
    """The leaves packed mode scans for a batch: ``d_lead`` [B, l] -> [B, b]
    leaf indices, -1 past the end (the nearest ``b`` of the leaves under
    the beam's last internal level, ties to the lower position)."""
    B = d_lead.shape[0]
    dev = d_lead.device
    cand = torch.arange(index.nodes[0], device=dev).expand(B, -1)
    d = d_lead[:, : index.nodes[0]]
    for i in range(index.levels - 1):
        keep = torch.sort(d, dim=1, stable=True).indices[:, : max(b, 8)]
        cand = torch.gather(cand, 1, keep)
        lists = index.children[i]
        table = torch.full((len(lists), max(1, max(len(c) for c in lists))), -1,
                           dtype=torch.int64, device=dev)
        for j, c in enumerate(lists):
            table[j, : len(c)] = torch.as_tensor(c, dtype=torch.int64, device=dev)
        cand = torch.where((cand >= 0)[..., None], table[cand.clamp(min=0)], -1).reshape(B, -1)
        d = torch.where(cand >= 0, torch.gather(d_lead, 1, cand.clamp(min=0)), math.inf)
    order = torch.sort(d, dim=1, stable=True).indices[:, :b]
    return torch.where(torch.gather(d, 1, order) < math.inf, torch.gather(cand, 1, order), -1)


def rank_items(qn: torch.Tensor, datan_rows, leaves, index: Index, depth: int):
    """The first ``depth`` items of the leaves one query opened, by
    distance: (ids [depth] int64, distances [depth] float64) numpy.
    ``datan_rows(ids)`` gives unit rows of the collection in the
    computing dtype."""
    ids = np.concatenate([index.members[int(j)] for j in leaves if j >= 0])
    d = cos_dist(qn[None, :], datan_rows(ids))[0]
    order = torch.sort(d, stable=True).indices[:depth].cpu().numpy()
    return ids[order], d.cpu().numpy()[order]


@dataclass
class Searcher:
    """The reference put in a program's place: pages of ``k`` for query
    rows, under ``semantics`` "best_first" or "beam"."""

    data: torch.Tensor   # [N, D] storage dtype, on the computing device
    index: Index
    semantics: str
    dtype: torch.dtype
    b: int
    k: int
    mx_inc: int = 4

    @functools.cached_property
    def lead(self) -> torch.Tensor:
        """Unit leader rows in the computing dtype."""
        return unit(self.data[torch.as_tensor(self.index.leaders, device=self.data.device)], self.dtype)

    def rows(self, ids: np.ndarray) -> torch.Tensor:
        return unit(self.data[torch.as_tensor(ids, device=self.data.device)], self.dtype)

    def opened(self, q: np.ndarray) -> list[list[int]]:
        """The leaves each query row opens."""
        qn = unit(torch.as_tensor(q, device=self.data.device), self.dtype)
        d = cos_dist(qn, self.lead)
        if self.semantics == "beam":
            return [[int(j) for j in row if j >= 0] for row in beam(d, self.index, self.b).cpu().numpy()]
        dh = d.cpu().numpy()
        return [best_first(dh[r], self.index, self.b, self.k, self.mx_inc) for r in range(len(q))]

    def pages(self, q: np.ndarray, n_pages: int, routes=None):
        """[rows] lists of ``n_pages`` (ids, distances) pages (``routes``:
        a federation's; one index has none)."""
        qn = unit(torch.as_tensor(q, device=self.data.device), self.dtype)
        out = []
        for r, leaves in enumerate(self.opened(q)):
            ids, d = rank_items(qn[r], self.rows, leaves, self.index, n_pages * self.k)
            out.append([(ids[p * self.k : (p + 1) * self.k], d[p * self.k : (p + 1) * self.k])
                        for p in range(n_pages)])
        return out


# ------------------------------------------------------------ federations
def shard_bounds(n_items: int, spec: dict) -> list[tuple[int, int]]:
    """The rows [lo, hi) of each shard of a ``shards`` block: ``n``
    contiguous slices of as near equal size as whole rows allow."""
    if spec.get("split", "contiguous") != "contiguous":
        raise ValueError(f"unknown split {spec['split']!r}")
    s = int(spec["n"])
    return [(i * n_items // s, (i + 1) * n_items // s) for i in range(s)]


def offset(index: Index, lo: int) -> Index:
    """``index`` with its item ids (leaders, members) moved by ``lo``."""
    return Index(index.leaders + lo, index.nodes, index.children, [m + lo for m in index.members])


def build_shards(data: torch.Tensor, cfg: dict, dtype) -> list[Index]:
    """Each shard's index as a build derives it from its slice, in global ids."""
    return [offset(build(data[lo:hi], cfg, dtype), lo) for lo, hi in shard_bounds(data.shape[0], cfg["shards"])]


def allocate(d: np.ndarray, owner: np.ndarray, b: int, n_shards: int, *, b_min: int = 1,
             top_m: int | None = None, probe_m: int = 1) -> dict[int, int]:
    """The effort split of one query: ``d`` its distance to each router
    centroid, ``owner`` each centroid's shard.  The ``b`` nearest
    centroids vote for their shards; at most ``top_m`` of the voted shards
    are probed (most votes first, then the nearer centroid, then the lower
    shard), and never more than ``b`` can fund at ``max(1, b_min) *
    probe_m`` each; they share ``b`` in proportion to their votes, rounded
    down, at least that floor each; what is left goes one by one from the
    most-voted shard on, what is over comes back one by one from the
    least-voted shard above its floor.  -> {shard: its share of ``b``}."""
    b = max(1, int(b))
    floor = max(1, int(b_min)) * max(1, int(probe_m))
    votes = np.bincount(owner[np.argsort(d, kind="stable")[:b]], minlength=n_shards)
    nearest = np.full(n_shards, np.inf)
    np.minimum.at(nearest, owner, d)
    cand = sorted((s for s in range(n_shards) if np.isfinite(nearest[s])),
                  key=lambda s: (-votes[s], nearest[s], s))
    cand = [s for s in cand if votes[s] > 0] or cand[:1]
    m = len(cand) if top_m is None else max(1, min(int(top_m), len(cand)))
    probe = cand[: min(m, max(1, b // floor))]
    if len(probe) == 1:
        return {probe[0]: b}
    w = [int(votes[s]) for s in probe]
    share = [max(floor, b * x // sum(w)) for x in w]
    left, i = b - sum(share), 0
    while left > 0:
        share[i % len(probe)] += 1
        left, i = left - 1, i + 1
    while left < 0:
        j = len(probe) - 1 - i % len(probe)
        if share[j] > floor:
            share[j] -= 1
            left += 1
        i += 1
    return dict(zip(probe, share))


def _tie_swaps(d: np.ndarray, owner: np.ndarray, tie: float):
    """``d`` with the distances of two centroids of different shards
    swapped, for each such pair that lies within ``tie``."""
    order = np.argsort(d, kind="stable")
    for a in range(len(order)):
        for c in range(a + 1, len(order)):
            i, j = order[a], order[c]
            if d[j] - d[i] > tie:
                break
            if owner[i] != owner[j]:
                swapped = d.copy()
                swapped[[i, j]] = d[[j, i]]
                yield swapped


class _Stream:
    """One probed shard's emissions for one query row: its items in
    batches of ``k``, nearest first among those it has staged and not yet
    emitted.  Best-first: one increment at the start (the ``b`` nearest
    leaves, then on while fewer than ``k`` items are staged, ``b``
    doubling at most ``mx_inc`` times), another whenever an emission finds
    fewer than ``k`` staged items and nodes are left; empty leaves are
    skipped uncounted.  Beam: the ``b`` leaves of the beam, nothing more."""

    def __init__(self, fed: "Federation", shard: int, d_lead: torch.Tensor, qn: torch.Tensor, b: int):
        self.fed, self.index, self.qn, self.b = fed, fed.shards[shard], qn, b
        self.ids, self.d = np.zeros(0, np.int64), np.zeros(0)
        self.inc, self.heap = 0, []
        if fed.semantics == "beam":
            self._stage([int(j) for j in beam(d_lead[None], self.index, b)[0].cpu().numpy() if j >= 0])
        else:
            self.d_lead = d_lead.cpu().numpy()
            self.heap = [(float(self.d_lead[j]), j, 1, j) for j in range(self.index.nodes[0])]
            heapq.heapify(self.heap)
            self.seq = len(self.heap)
            self._increment(fed.k)
        self.buf, self.pos, self.done = self.emit(fed.k), 0, False

    def _stage(self, leaves: list[int]) -> None:
        if not leaves:
            return
        ids = np.concatenate([self.ids] + [self.index.members[j] for j in leaves])
        d = np.concatenate([self.d, cos_dist(self.qn[None], self.fed.rows(ids[len(self.ids):]))[0].cpu().numpy()])
        order = np.argsort(d, kind="stable")
        self.ids, self.d = ids[order], d[order]

    def _increment(self, k: int) -> None:
        L, idx = self.index.levels, self.index
        budget, count, staged, opened = self.b, 0, len(self.ids), []
        while self.heap:
            _, _, level, node = heapq.heappop(self.heap)
            if level < L:
                for c in idx.children[level - 1][node]:
                    heapq.heappush(self.heap, (float(self.d_lead[c]), self.seq, level + 1, int(c)))
                    self.seq += 1
                continue
            if len(idx.members[node]) == 0:
                continue
            opened.append(node)
            count += 1
            staged += len(idx.members[node])
            if count >= budget:
                if staged >= k:
                    break
                if self.fed.mx_inc == -1 or self.inc < self.fed.mx_inc:
                    self.inc += 1
                    budget *= 2
                else:
                    break
        self._stage(opened)

    def emit(self, k: int) -> list[tuple[float, int]]:
        if len(self.ids) < k and self.heap:
            self._increment(k)
        out = list(zip(self.d[:k].tolist(), self.ids[:k].tolist()))
        self.ids, self.d = self.ids[k:], self.d[k:]
        return out

    def head(self):
        return self.buf[self.pos] if self.pos < len(self.buf) else None

    def refill(self, k: int) -> None:
        if not self.done:
            self.buf, self.pos = self.emit(k), 0
            self.done = not self.buf


@dataclass
class Federation:
    """The reference put in a federation's place: ``shards`` (indexes in
    global ids, shard order) routed, split and merged as the module's
    docstring says; otherwise as ``Searcher``."""

    data: torch.Tensor
    shards: list[Index]
    semantics: str
    dtype: torch.dtype
    b: int
    k: int
    b_min: int = 1
    top_m: int | None = None
    probe_m: int = 1
    mx_inc: int = 4
    tie: float = 0.0

    def __post_init__(self):
        if self.probe_m != 1:
            raise NotImplementedError("the reference searches a shard one node at a time (probe_m 1)")

    @functools.cached_property
    def leads(self) -> list[torch.Tensor]:
        """Each shard's unit leader rows in the computing dtype."""
        return [self.rows(s.leaders) for s in self.shards]

    @functools.cached_property
    def owner(self) -> np.ndarray:
        """The shard of each router centroid (each shard's level-1 nodes, in shard order)."""
        return np.repeat(np.arange(len(self.shards)), [s.nodes[0] for s in self.shards])

    def rows(self, ids: np.ndarray) -> torch.Tensor:
        return unit(self.data[torch.as_tensor(ids, device=self.data.device)], self.dtype)

    def route(self, d: np.ndarray, chosen: dict | None = None) -> dict[int, int]:
        """The split of one query whose router distances are ``d``; the
        program's ``chosen`` split stands where centroids of two shards
        within ``tie`` of each other, taken in the other order, give it."""
        args = (self.owner, self.b, len(self.shards))
        kw = {"b_min": self.b_min, "top_m": self.top_m, "probe_m": self.probe_m}
        own = allocate(d, *args, **kw)
        if chosen is None or chosen == own:
            return own
        return chosen if any(allocate(v, *args, **kw) == chosen for v in _tie_swaps(d, self.owner, self.tie)) else own

    def _distances(self, q: np.ndarray):
        """Unit query rows, their distances to each shard's leaders, and
        to the router centroids."""
        qn = unit(torch.as_tensor(q, device=self.data.device), self.dtype)
        d_lead = [cos_dist(qn, lead) for lead in self.leads]
        d_router = torch.cat([d[:, : s.nodes[0]] for d, s in zip(d_lead, self.shards)], 1).cpu().numpy()
        return qn, d_lead, d_router

    def splits(self, q: np.ndarray) -> list[dict[int, int]]:
        """Each query row's split of ``b``."""
        d_router = self._distances(q)[2]
        return [self.route(d) for d in d_router]

    def pages(self, q: np.ndarray, n_pages: int, routes: list | None = None):
        """[rows] lists of ``n_pages`` (ids, distances) pages; ``routes``:
        the program's split of each row ({shard: b}, or None), kept only
        within ``tie``."""
        qn, d_lead, d_router = self._distances(q)
        out = []
        for r in range(len(q)):
            split = self.route(d_router[r], routes[r] if routes else None)
            streams = [_Stream(self, s, d_lead[s][r], qn[r], b) for s, b in split.items()]
            out.append([_merge(streams, self.k, refill=p > 0) for p in range(n_pages)])
        return out


def _merge(streams: list[_Stream], k: int, refill: bool) -> tuple[np.ndarray, np.ndarray]:
    """The next page of ``k`` over the streams, least (distance, id)
    first.  With ``refill`` (a page after the first), a stream whose
    emission is used up asks for its next one, before and while merging;
    the first page merges the first emissions alone."""
    if refill:
        for st in streams:
            if st.head() is None:
                st.refill(k)
    ids, dists = [], []
    while len(ids) < k:
        live = [st for st in streams if st.head() is not None]
        if not live:
            break
        best = min(live, key=lambda st: st.head())
        d, i = best.head()
        best.pos += 1
        dists.append(d)
        ids.append(i)
        if refill and best.head() is None:
            best.refill(k)
    return np.asarray(ids, np.int64), np.asarray(dists, np.float64)


def make_searcher(data: torch.Tensor, index, cfg: dict, dtype, tie: float = 0.0):
    """The reference in the program's place for configuration ``cfg``:
    ``index`` one ``Index``, or with ``shards`` a list of them."""
    b, k = int(cfg["b"]), int(cfg["k"])
    if "shards" not in cfg:
        return Searcher(data, index, cfg["semantics"], dtype, b, k)
    o = cfg["open"]
    return Federation(data, index, cfg["semantics"], dtype, b, k, b_min=int(o.get("b_min", 1)),
                      top_m=o.get("top_m"), probe_m=int(o.get("probe_m", 1)), tie=tie)
