"""Batched eCP search on the device (level-synchronous beam + resumable
state) — the port's counterpart of the reference's ``core/batched.py``.

The paper's single-query priority queue is inherently sequential; packed
mode restores eCP's per-level synchronization so a whole query batch
advances level by level with dense distance blocks and top-k selections:

  1. score the root centroids, take the best ``b`` lvl_1 nodes;
  2. per internal level: score the children of the chosen nodes, re-top-b;
  3. at the last internal level, *rank* every candidate leaf (not just the
     top-b) — the device analogue of the priority queue, which is what
     makes the search resumable;
  4. scan ``b`` leaves at a time, merging scanned items into a bounded,
     sorted candidate buffer per query.

The stages are plain functions on tensors resident on ``device``; the
state is a dataclass of tensors (``BatchedQueryState``).  Every top-k
keeps equal distances in index order, as ``jax.lax.top_k`` and the stable
``jnp.argsort`` of the reference do (``torch.topk`` promises no order).

Scoring never gathers a ``[B, b, cap, D]`` block (at the paper's widths one
such gather is hundreds of GB): each internal level is scored as one
product of the queries against all its children's centroids, and a leaf
chunk scores each distinct visited leaf once against every query, in
blocks of leaves sized to ``scan_budget_bytes``, then picks each query's
rows out of the products.  For cosine the rows are unit-normalised once
at load (the arithmetic the reference repeats on every scan); for l2 the
rows' squared norms are computed once.  The distances are the reference's
``jnp_distances`` einsums as float32 products; no custom kernel runs here,
in either package.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .api import Query, ResultSet, SearchStats
from .distances import _check
from .packed import PackedIndex

__all__ = ["BatchedQuery", "BatchedQueryState", "BatchedSearcher"]


@dataclass
class BatchedQueryState:
    leaf_rank: torch.Tensor    # [B, R] int64 leaf ids in visit order (-1 pad)
    leaf_rank_d: torch.Tensor  # [B, R] float32 centroid distance of each ranked leaf
    next_ptr: torch.Tensor     # [B] int64 next rank position to visit
    buf_d: torch.Tensor        # [B, C] float32 sorted candidate distances (+inf pad)
    buf_i: torch.Tensor        # [B, C] int64 candidate item ids (-1 pad)


def _ascending_top_k(d: torch.Tensor, ids: torch.Tensor, k: int):
    """Smallest-k by distance, ascending; equal distances keep index order
    (a stable sort), as ``jax.lax.top_k`` on ``-d`` does."""
    order = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    return torch.gather(d, -1, order), torch.gather(ids, -1, order)


class _Rows:
    """Rows scored against queries: embeddings as the metric needs them
    (unit-normalised for cosine) and, for l2, their squared norms."""

    def __init__(self, emb: torch.Tensor, metric: str):
        if metric == "cosine":
            emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)
        self.emb = emb
        self.sq = torch.sum(emb * emb, dim=-1) if metric == "l2" else None

    @property
    def nbytes(self) -> int:
        return self.emb.numel() * 4 + (0 if self.sq is None else self.sq.numel() * 4)


def _prep_queries(q: torch.Tensor, metric: str):
    """(q as the metric needs it, its squared norms for l2)."""
    if metric == "cosine":
        return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12), None
    if metric == "l2":
        return q, torch.sum(q * q, dim=-1)
    return q, None


def _distances(qp, q_sq, emb: torch.Tensor, sq, metric: str) -> torch.Tensor:
    """[B, D] prepared queries x [N, D] rows -> [B, N] distances: the
    reference's ``jnp_distances`` with the row-side terms precomputed."""
    dot = qp @ emb.T
    if metric == "ip":
        return -dot
    if metric == "l2":
        return q_sq[:, None] + sq[None, :] - 2.0 * dot
    return 1.0 - dot


class BatchedQuery(Query):
    """Handle over the device-resident state of one batched search call."""

    def __init__(self, searcher: "BatchedSearcher", q: torch.Tensor, state: BatchedQueryState,
                 *, b: int, single: bool):
        self._searcher = searcher
        self._q = q
        self._state = state
        self._b = b
        self._single = single

    @property
    def state(self) -> BatchedQueryState:
        self._ensure_open()
        return self._state

    def next(self, k: int) -> ResultSet:
        self._ensure_open()
        d, i, self._state = self._searcher._advance(self._q, self._state, k, self._b)
        return self._searcher._result(d, i, self._state, self._single, self)

    def close(self) -> None:
        self._q = None
        self._state = None
        super().close()


class BatchedSearcher:
    """Device-resident packed index + the search stages (the ``Searcher``
    for packed mode).  ``device`` is "cuda" by default; "cpu" when asked."""

    # bytes one leaf block of a scan chunk may take on the device: the
    # block's gathered rows plus its [B, rows] distances
    scan_budget_bytes = 2 << 30

    def __init__(self, packed: PackedIndex, *, scorer=None, device="cuda"):
        self.device = resolve_device(device)
        self.info = packed.info
        self.metric = packed.info.metric
        _check(self.metric)
        dev = self.device

        def rows(a: np.ndarray) -> _Rows:
            return _Rows(torch.as_tensor(np.asarray(a, np.float32)).to(dev), self.metric)

        self.root = rows(packed.root_emb)
        # internal levels, flattened: node j's children are rows
        # [j * maxc, (j + 1) * maxc) of the level's block
        self.int_rows = [rows(p.emb.reshape(-1, p.emb.shape[-1])) for p in packed.levels[:-1]]
        self.int_maxc = [p.max_children for p in packed.levels[:-1]]
        self.int_ids = [torch.as_tensor(p.ids).to(dev).long() for p in packed.levels[:-1]]
        self.int_mask = [torch.as_tensor(p.mask).to(dev) for p in packed.levels[:-1]]
        leaf = packed.leaf
        self.leaf = rows(leaf.emb)                                   # [n_leaves, cap, D]
        self.leaf_ids = torch.as_tensor(leaf.ids).to(dev).long()    # [n_leaves, cap]
        self.leaf_mask = torch.as_tensor(leaf.mask).to(dev)         # [n_leaves, cap]
        # scorer(q[B,D], c[B,N,D]) -> [B,N] distances: the reference's hook
        # for another leaf distance; for cosine it sees unit-normalised rows
        self._scorer = scorer
        self._topk = _ascending_top_k

    @property
    def device_bytes(self) -> int:
        """Bytes of the resident packed index on the device."""
        n = self.root.nbytes + self.leaf.nbytes
        n += sum(r.nbytes for r in self.int_rows)
        n += sum(t.numel() * t.element_size() for t in (*self.int_ids, *self.int_mask))
        n += self.leaf_ids.numel() * 8 + self.leaf_mask.numel()
        return n

    # ------------------------------------------------------------- stage 1
    @torch.no_grad()
    def rank_leaves(self, q: torch.Tensor, b_internal: int):
        """[B, D] queries -> ranked candidate leaves [B, R] (+ distances)."""
        B = q.shape[0]
        qp, q_sq = _prep_queries(q, self.metric)
        d = _distances(qp, q_sq, self.root.emb, self.root.sq, self.metric)  # [B, n1]
        n1 = d.shape[-1]
        if not self.int_rows:  # L == 1: root children are the leaves
            order = torch.sort(d, dim=-1, stable=True).indices
            return order, torch.gather(d, -1, order)
        b = min(b_internal, n1)
        ar = torch.arange(n1, device=d.device).expand(B, n1)
        node_d, node = self._topk(d, ar, b)
        rows_b = torch.arange(B, device=d.device)[:, None]
        for li, (r, maxc, ids, mask) in enumerate(
            zip(self.int_rows, self.int_maxc, self.int_ids, self.int_mask)
        ):
            full = _distances(qp, q_sq, r.emb, r.sq, self.metric).view(B, -1, maxc)
            cd = full[rows_b, node]                                 # [B, b, maxc]
            cm = mask[node]
            cd = torch.where(cm, cd, torch.inf)
            cid = torch.where(cm, ids[node], -1)
            flat_d = cd.reshape(B, -1)
            flat_i = cid.reshape(B, -1)
            if li == len(self.int_rows) - 1:
                order = torch.sort(flat_d, dim=-1, stable=True).indices  # rank ALL leaves seen
                return torch.gather(flat_i, -1, order), torch.gather(flat_d, -1, order)
            bb = min(b_internal, flat_d.shape[-1])
            node_d, node = self._topk(flat_d, flat_i, bb)
            node = torch.clamp(node, min=0)                         # guard -1 pads
        raise AssertionError("unreachable")

    # ------------------------------------------------------------- stage 2
    def _leaf_dists(self, q: torch.Tensor, leaf_c: torch.Tensor) -> torch.Tensor:
        """Distances of each query to every row of its visited leaves:
        ``[B, D]`` x ``leaf_c [B, b]`` -> ``[B, b, cap]``."""
        B, b = leaf_c.shape
        cap, D = self.leaf.emb.shape[1], self.leaf.emb.shape[2]
        if self._scorer is not None:
            # the reference's call: each query against its own gathered
            # leaves, in blocks of queries that fit the budget
            qb = max(1, self.scan_budget_bytes // max(1, b * cap * D * 4))
            parts = [
                self._scorer(q[lo : lo + qb], self.leaf.emb[leaf_c[lo : lo + qb]].reshape(-1, b * cap, D))
                for lo in range(0, B, qb)
            ]
            return torch.cat(parts).view(B, b, cap)
        qp, q_sq = _prep_queries(q, self.metric)
        u, inv = torch.unique(leaf_c, return_inverse=True)          # distinct visited leaves
        ub = max(1, self.scan_budget_bytes // (cap * (D + B) * 4))
        rows_b = torch.arange(B, device=q.device)[:, None]
        out = None
        for lo in range(0, u.numel(), ub):
            blk = u[lo : lo + ub]
            sq = None if self.leaf.sq is None else self.leaf.sq[blk].reshape(-1)
            d = _distances(qp, q_sq, self.leaf.emb[blk].reshape(-1, D), sq, self.metric)
            d = d.view(B, -1, cap)
            if lo == 0 and blk.numel() == u.numel():
                return d[rows_b, inv]
            rel = torch.clamp(inv - lo, 0, blk.numel() - 1)
            part = d[rows_b, rel]
            inside = ((inv >= lo) & (inv < lo + blk.numel()))[..., None]
            out = part if out is None else torch.where(inside, part, out)
        return out

    @torch.no_grad()
    def _scan_chunk(self, q: torch.Tensor, state: BatchedQueryState, b: int) -> BatchedQueryState:
        """Visit the next ``b`` ranked leaves; merge items into the buffer."""
        B = q.shape[0]
        R = state.leaf_rank.shape[1]
        pos = state.next_ptr[:, None] + torch.arange(b, device=q.device)[None, :]  # [B, b]
        valid = pos < R
        pos_c = torch.clamp(pos, max=R - 1)
        leaf = torch.gather(state.leaf_rank, -1, pos_c)                          # [B, b]
        lvalid = valid & (leaf >= 0)
        leaf_c = torch.clamp(leaf, min=0)
        d = self._leaf_dists(q, leaf_c)                                           # [B, b, cap]
        mask = (self.leaf_mask[leaf_c] & lvalid[..., None]).reshape(B, -1)
        d = torch.where(mask, d.reshape(B, -1), torch.inf)
        i = torch.where(mask, self.leaf_ids[leaf_c].reshape(B, -1), -1)
        # merge with buffer, re-sort, keep best C
        C = state.buf_d.shape[1]
        buf_d, buf_i = self._topk(
            torch.cat([state.buf_d, d], dim=-1), torch.cat([state.buf_i, i], dim=-1), C
        )
        return BatchedQueryState(
            leaf_rank=state.leaf_rank,
            leaf_rank_d=state.leaf_rank_d,
            next_ptr=state.next_ptr + b,
            buf_d=buf_d,
            buf_i=buf_i,
        )

    @staticmethod
    def _emit(state: BatchedQueryState, k: int):
        out_d = state.buf_d[:, :k]
        out_i = state.buf_i[:, :k]
        B, C = state.buf_d.shape
        dev = state.buf_d.device
        rem_d = torch.cat([state.buf_d[:, k:], torch.full((B, k), torch.inf, device=dev)], dim=-1)
        rem_i = torch.cat(
            [state.buf_i[:, k:], torch.full((B, k), -1, dtype=torch.int64, device=dev)], dim=-1
        )
        new = BatchedQueryState(
            state.leaf_rank, state.leaf_rank_d, state.next_ptr, rem_d[:, :C], rem_i[:, :C]
        )
        return out_d, out_i, new

    # ---------------------------------------------------------------- API
    def search(
        self,
        q,
        k: int = 100,
        *,
        b: int | None = 8,
        b_internal: int | None = None,
        buffer_cap: int | None = None,
    ) -> ResultSet:
        """New batched search over [D] or [B, D] queries -> ``ResultSet``."""
        b = 8 if b is None else int(b)
        q = q if torch.is_tensor(q) else torch.from_numpy(np.asarray(q, np.float32))
        q = q.to(self.device, torch.float32)
        single = q.ndim == 1
        if single:
            q = q[None, :]
        B = q.shape[0]
        bi = b_internal if b_internal is not None else max(b, 8)
        leaf_rank, leaf_rank_d = self.rank_leaves(q, bi)
        C = buffer_cap if buffer_cap is not None else max(4 * k, 256)
        state = BatchedQueryState(
            leaf_rank=leaf_rank,
            leaf_rank_d=leaf_rank_d,
            next_ptr=torch.zeros((B,), dtype=torch.int64, device=self.device),
            buf_d=torch.full((B, C), torch.inf, device=self.device),
            buf_i=torch.full((B, C), -1, dtype=torch.int64, device=self.device),
        )
        state = self._scan_chunk(q, state, min(b, leaf_rank.shape[1]))
        d, i, state = self._advance(q, state, k, b)
        return self._result(d, i, state, single, BatchedQuery(self, q, state, b=b, single=single))

    def _advance(self, q: torch.Tensor, state: BatchedQueryState, k: int, b: int):
        """Emit the next k items, scanning further leaves if needed (one
        host synchronisation per chunk: the loop's test)."""
        R = state.leaf_rank.shape[1]
        # scan until every query has k buffered candidates or leaves exhaust
        for _ in range(64):  # hard bound, as in the reference
            have = torch.isfinite(state.buf_d[:, :k]).sum(dim=-1)
            exhausted = state.next_ptr >= R
            if bool(torch.all((have >= k) | exhausted)):
                break
            state = self._scan_chunk(q, state, min(b, R))
        return self._emit(state, k)

    def _result(self, d, i, state: BatchedQueryState, single: bool, query) -> ResultSet:
        d = d.cpu().numpy().astype(np.float32)
        i = i.cpu().numpy().astype(np.int64)
        # leaves actually scanned per query (ranked positions visited)
        ptr = state.next_ptr.cpu().numpy()
        stats = [SearchStats(leaves_opened=int(p)) for p in ptr]
        if single:
            return ResultSet(dists=d[0], ids=i[0], stats=stats[0], query=query)
        return ResultSet(dists=d, ids=i, stats=stats, query=query)

    def __repr__(self) -> str:
        return f"BatchedSearcher(levels={self.info.levels}, metric={self.metric!r}, device={self.device})"
