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

    def pages(self, q: np.ndarray, n_pages: int):
        """[rows] lists of ``n_pages`` (ids, distances) pages."""
        qn = unit(torch.as_tensor(q, device=self.data.device), self.dtype)
        out = []
        for r, leaves in enumerate(self.opened(q)):
            ids, d = rank_items(qn[r], self.rows, leaves, self.index, n_pages * self.k)
            out.append([(ids[p * self.k : (p + 1) * self.k], d[p * self.k : (p + 1) * self.k])
                        for p in range(n_pages)])
        return out
