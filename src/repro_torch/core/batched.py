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
product of the queries against all its children's centroids.  A leaf
chunk is scored by ``kernels.leaf_distances``: on the card one launch of
the hand-written ``csrc/leaf_distances.cu``, which reads each visited
leaf's real rows in place and scores them against only the queries whose
beams chose it; on the CPU its plain version, which scores each distinct
visited leaf, padded to the largest, once against every query in blocks
of leaves and picks each query's rows out of the products.  A chunk is
merged into the buffer by ``kernels.leaf_merge``: on the card one launch
of the hand-written ``csrc/leaf_merge.cu``, which selects each query's
best C from its buffer and only the real rows of its valid slots, read in
place; on the CPU its plain version, which masks the padding, appends the
chunk to the buffer and keeps the best C of a stable sort.  For cosine the rows are
unit-normalised once at load (the arithmetic the reference repeats on
every scan); for l2 the rows' squared norms are computed once, and a
search prepares its queries once for its scan and its ``next`` calls.  The
distances are the reference's ``jnp_distances`` in float32 (the
reference runs XLA's products).

The host waits for the device (on a GPU) at three sites, and the plain
scoring adds a fourth; each is counted as ``ecpfs.packed.host_syncs``
while tracing is on (``repro_torch.tracing``): the upload of queries that
arrive in host memory; ``_advance``'s test, once per loop pass;
``_result``'s three copies back; and, on the CPU, the plain scoring's
``torch.unique``, once per scan chunk.  A search passes the upload, one
test per pass and the three copies; a ``next`` the same without the
upload.  The stages' spans are
``ecpfs.packed.upload``, ``.rank``, ``.score``, ``.merge``, ``.advance``
(its test ``.advance.wait``), ``.emit`` and ``.result``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device
from ..kernels.leaf_distances import leaf_distances, rows_scored
from ..kernels.leaf_distances.ref import prepared_distances
from ..kernels.leaf_merge import leaf_merge
from ..kernels.leaf_merge.ref import ascending_top_k
from .api import Query, ResultSet, SearchStats
from .distances import _check
from .packed import PackedIndex

__all__ = ["BatchedQuery", "BatchedQueryState", "BatchedSearcher"]


@dataclass
class BatchedQueryState:
    leaf_rank: torch.Tensor  # [B, R] int64 leaf ids in visit order (-1 pad)
    next_ptr: torch.Tensor   # [B] int64 next rank position to visit
    buf_d: torch.Tensor      # [B, C] float32 sorted candidate distances (+inf pad)
    buf_i: torch.Tensor      # [B, C] int64 candidate item ids (-1 pad)


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


@dataclass
class _Level:
    """An internal level on the device, flattened: node j's children are
    rows [j * maxc, (j + 1) * maxc) of ``rows``."""
    rows: _Rows          # [n_nodes * maxc, D]
    ids: torch.Tensor    # [n_nodes, maxc] int64 child node ids (-1 pad)
    mask: torch.Tensor   # [n_nodes, maxc] bool


def _prep_queries(q: torch.Tensor, metric: str):
    """(q as the metric needs it, its squared norms for l2)."""
    if metric == "cosine":
        return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12), None
    if metric == "l2":
        return q, torch.sum(q * q, dim=-1)
    return q, None


def _prefix_rows(mask: np.ndarray) -> np.ndarray:
    """[n_leaves, cap] masks -> [n_leaves] int32 real rows, on the host.
    Each mask must be a prefix of its leaf's rows, as ``pack_children``
    fills them."""
    n = mask.sum(axis=1)
    if not np.array_equal(mask, np.arange(mask.shape[1]) < n[:, None]):
        raise ValueError("a leaf's mask is not a prefix of its rows")
    return n.astype(np.int32)


class BatchedQuery(Query):
    """Handle over the device-resident state of one batched search call."""

    def __init__(self, searcher: "BatchedSearcher", qp: torch.Tensor, q_sq, state: BatchedQueryState,
                 *, b: int, single: bool):
        self._searcher = searcher
        self._q = (qp, q_sq)  # the queries as the scan takes them
        self._state = state
        self._b = b
        self._single = single

    @property
    def state(self) -> BatchedQueryState:
        self._ensure_open()
        return self._state

    def next(self, k: int) -> ResultSet:
        self._ensure_open()
        d, i, self._state = self._searcher._advance(*self._q, self._state, k, self._b)
        return self._searcher._result(d, i, self._state, self._single, self)

    def close(self) -> None:
        self._q = None
        self._state = None
        super().close()


class BatchedSearcher:
    """Device-resident packed index + the search stages (the ``Searcher``
    for packed mode).  ``device`` is "cuda" by default; "cpu" when asked."""

    def __init__(self, packed: PackedIndex, *, device="cuda"):
        self.device = resolve_device(device)
        self.info = packed.info
        self.metric = packed.info.metric
        _check(self.metric)
        dev = self.device

        def rows(a: np.ndarray) -> _Rows:
            return _Rows(torch.as_tensor(np.asarray(a, np.float32)).to(dev), self.metric)

        self.root = rows(packed.root_emb)
        self.levels = [  # the internal levels; the leaves are below
            _Level(rows(p.emb.reshape(-1, p.emb.shape[-1])), torch.as_tensor(p.ids).to(dev).long(),
                   torch.as_tensor(p.mask).to(dev))
            for p in packed.levels[:-1]
        ]
        leaf = packed.leaf
        self.leaf = rows(leaf.emb)                                                # [n_leaves, cap, D]
        self.leaf_ids = torch.as_tensor(leaf.ids).to(dev).long()                 # [n_leaves, cap]
        self.n_rows = torch.from_numpy(_prefix_rows(np.asarray(leaf.mask))).to(dev)  # [n_leaves] int32

    @property
    def device_bytes(self) -> int:
        """Bytes of the resident packed index on the device."""
        n = self.root.nbytes + self.leaf.nbytes
        n += sum(lv.rows.nbytes + lv.ids.numel() * 8 + lv.mask.numel() for lv in self.levels)
        n += self.leaf_ids.numel() * 8 + self.n_rows.numel() * 4
        return n

    # ------------------------------------------------------------- stage 1
    @torch.no_grad()
    def rank_leaves(self, q: torch.Tensor, b_internal: int):
        """[B, D] queries -> ranked candidate leaves [B, R] (+ distances)."""
        with tracing.span("ecpfs.packed.rank", device=self.device):
            B = q.shape[0]
            qp, q_sq = _prep_queries(q, self.metric)
            d = prepared_distances(qp, q_sq, self.root.emb, self.root.sq, self.metric)  # [B, n1]
            n1 = d.shape[-1]
            if not self.levels:  # L == 1: root children are the leaves
                order = torch.sort(d, dim=-1, stable=True).indices
                return order, torch.gather(d, -1, order)
            b = min(b_internal, n1)
            ar = torch.arange(n1, device=d.device).expand(B, n1)
            _, node = ascending_top_k(d, ar, b)
            rows_b = torch.arange(B, device=d.device)[:, None]
            for li, lv in enumerate(self.levels):
                full = prepared_distances(qp, q_sq, lv.rows.emb, lv.rows.sq, self.metric).view(B, -1, lv.ids.shape[1])
                cd = full[rows_b, node]                                 # [B, b, maxc]
                cm = lv.mask[node]
                cd = torch.where(cm, cd, torch.inf)
                cid = torch.where(cm, lv.ids[node], -1)
                flat_d = cd.reshape(B, -1)
                flat_i = cid.reshape(B, -1)
                if li == len(self.levels) - 1:
                    order = torch.sort(flat_d, dim=-1, stable=True).indices  # rank ALL leaves seen
                    return torch.gather(flat_i, -1, order), torch.gather(flat_d, -1, order)
                bb = min(b_internal, flat_d.shape[-1])
                _, node = ascending_top_k(flat_d, flat_i, bb)
                node = torch.clamp(node, min=0)                         # guard -1 pads
            raise AssertionError("unreachable")

    # ------------------------------------------------------------- stage 2
    def _leaf_dists(self, qp: torch.Tensor, q_sq, leaf_c: torch.Tensor, lvalid: torch.Tensor) -> torch.Tensor:
        """Distances of each prepared query to every row of its visited
        leaves: ``[B, D]`` x ``leaf_c [B, b]`` -> ``[B, b, cap]``.  The merge
        masks the rows past each leaf's real ones and the slots ``lvalid``
        leaves out: neither version puts a distance there."""
        with tracing.span("ecpfs.packed.score", device=self.device):
            if tracing.enabled():
                tracing.count("ecpfs.packed.rows_scored",
                              rows_scored(leaf_c, lvalid, self.n_rows, self.leaf.emb.shape[1]))
            return leaf_distances(qp, q_sq, self.leaf.emb, self.leaf.sq, self.n_rows, leaf_c, lvalid, self.metric)

    @torch.no_grad()
    def _scan_chunk(self, qp: torch.Tensor, q_sq, state: BatchedQueryState, b: int) -> BatchedQueryState:
        """Visit the next ``b`` ranked leaves; merge items into the buffer."""
        R = state.leaf_rank.shape[1]
        pos = state.next_ptr[:, None] + torch.arange(b, device=qp.device)[None, :]  # [B, b]
        valid = pos < R
        pos_c = torch.clamp(pos, max=R - 1)
        leaf = torch.gather(state.leaf_rank, -1, pos_c)                          # [B, b]
        lvalid = valid & (leaf >= 0)
        leaf_c = torch.clamp(leaf, min=0)
        d = self._leaf_dists(qp, q_sq, leaf_c, lvalid)                            # [B, b, cap]
        with tracing.span("ecpfs.packed.merge", device=self.device):
            if tracing.enabled():
                tracing.count("ecpfs.packed.rows_needed", (self.n_rows[leaf_c] * lvalid).sum())
            buf_d, buf_i = leaf_merge(state.buf_d, state.buf_i, d, self.leaf_ids, self.n_rows, leaf_c, lvalid)
        return BatchedQueryState(
            leaf_rank=state.leaf_rank,
            next_ptr=state.next_ptr + b,
            buf_d=buf_d,
            buf_i=buf_i,
        )

    @staticmethod
    def _emit(state: BatchedQueryState, k: int):
        with tracing.span("ecpfs.packed.emit"):
            out_d = state.buf_d[:, :k]
            out_i = state.buf_i[:, :k]
            B, C = state.buf_d.shape
            dev = state.buf_d.device
            rem_d = torch.cat([state.buf_d[:, k:], torch.full((B, k), torch.inf, device=dev)], dim=-1)
            rem_i = torch.cat(
                [state.buf_i[:, k:], torch.full((B, k), -1, dtype=torch.int64, device=dev)], dim=-1
            )
            # contiguous, as the merge takes it, also where k > C
            new = BatchedQueryState(state.leaf_rank, state.next_ptr, rem_d[:, :C].contiguous(),
                                    rem_i[:, :C].contiguous())
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
        with tracing.span("ecpfs.packed.upload"):
            if q.device.type == "cpu":
                tracing.count("ecpfs.packed.host_syncs")  # a copy from host memory
            q = q.to(self.device, torch.float32)
        single = q.ndim == 1
        if single:
            q = q[None, :]
        B = q.shape[0]
        bi = b_internal if b_internal is not None else max(b, 8)
        leaf_rank, _ = self.rank_leaves(q, bi)
        qp, q_sq = _prep_queries(q, self.metric)
        qp = qp.contiguous()  # as leaf_distances takes it
        C = buffer_cap if buffer_cap is not None else max(4 * k, 256)
        state = BatchedQueryState(
            leaf_rank=leaf_rank,
            next_ptr=torch.zeros((B,), dtype=torch.int64, device=self.device),
            buf_d=torch.full((B, C), torch.inf, device=self.device),
            buf_i=torch.full((B, C), -1, dtype=torch.int64, device=self.device),
        )
        state = self._scan_chunk(qp, q_sq, state, min(b, leaf_rank.shape[1]))
        d, i, state = self._advance(qp, q_sq, state, k, b)
        return self._result(d, i, state, single, BatchedQuery(self, qp, q_sq, state, b=b, single=single))

    def _advance(self, qp: torch.Tensor, q_sq, state: BatchedQueryState, k: int, b: int):
        """Emit the next k items, scanning further leaves if needed (the
        host waits once per loop pass, at the test, and on the CPU once per
        further chunk, at the plain scoring's ``torch.unique``)."""
        with tracing.span("ecpfs.packed.advance"):
            R = state.leaf_rank.shape[1]
            # scan until every query has k buffered candidates or leaves exhaust
            for _ in range(64):  # hard bound, as in the reference
                have = torch.isfinite(state.buf_d[:, :k]).sum(dim=-1)
                exhausted = state.next_ptr >= R
                with tracing.span("ecpfs.packed.advance.wait"):
                    tracing.count("ecpfs.packed.host_syncs")
                    done = bool(torch.all((have >= k) | exhausted))
                if done:
                    break
                state = self._scan_chunk(qp, q_sq, state, min(b, R))
            return self._emit(state, k)

    def _result(self, d, i, state: BatchedQueryState, single: bool, query) -> ResultSet:
        with tracing.span("ecpfs.packed.result"):
            tracing.count("ecpfs.packed.host_syncs", 3)  # the three copies back
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
