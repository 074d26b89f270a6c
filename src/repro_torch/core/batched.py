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

On a CUDA device a search shape (``B``, ``b``, ``b_internal``, ``C``)
runs eagerly at its first search on a searcher, which builds the
kernels, and is captured when the next search has the same shape into
three CUDA graphs, one a span (``_Graphs``), each recorded from the body
the eager path runs: *rank* (``_rank``, ``rank_leaves``' body, and
``_start``: the queries prepared and the state's initial buffers),
*score* (``_score``: a chunk's positions and the ``leaf_distances``
launch, ``leaf_work`` included) and *merge* (``_merge``: the
``leaf_merge`` launch and the pointer moved on).  From then on a search
replays rank, score and merge, and a further chunk copies its session's
queries and state in and replays score and merge, under the searcher's
lock from the copy in to the copy out; a session keeps copies, never the
graphs' static tensors.  Each span times its replay alone (the events
are recorded around it, never captured; the copies lie outside); each
replayed chunk counts one launch of each kernel and one
``ecpfs.packed.graph_replays``; a capture counts one
``ecpfs.packed.graph_captures``.  A searcher keeps ``GRAPH_SHAPES``
shapes; others stay eager, as does every search on the CPU.  The graphs'
memory pool is not in ``device_bytes`` (the resident index alone).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device
from ..kernels import _build
from ..kernels import leaf_distances as _ld
from ..kernels import leaf_merge as _lm
from ..kernels.leaf_distances import leaf_distances, rows_scored
from ..kernels.leaf_distances.ref import prepared_distances
from ..kernels.leaf_merge import leaf_merge
from ..kernels.leaf_merge.ref import ascending_top_k
from .api import Query, ResultSet, SearchStats
from .distances import _check
from .packed import PackedIndex

__all__ = ["GRAPH_SHAPES", "BatchedQuery", "BatchedQueryState", "BatchedSearcher"]

# search shapes a searcher keeps captured on a CUDA device; further shapes
# run eagerly.  The benchmark's traffic searches one shape (128 rows, b 64,
# C 400: a 172 MB static [B, b, cap] block at 1M items); a second lets one
# more steady shape replay while the pools stay within two shapes' memory.
GRAPH_SHAPES = 2


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


def _chunk_slots(leaf_rank: torch.Tensor, next_ptr: torch.Tensor, w: int):
    """The next ``w`` ranked leaves of each query: (leaf_c [B, w] int64
    leaf ids clamped into range, lvalid [B, w] bool the slots that hold a
    leaf)."""
    R = leaf_rank.shape[1]
    pos = next_ptr[:, None] + torch.arange(w, device=leaf_rank.device)[None, :]  # [B, w]
    valid = pos < R
    pos_c = torch.clamp(pos, max=R - 1)
    leaf = torch.gather(leaf_rank, -1, pos_c)                                    # [B, w]
    return torch.clamp(leaf, min=0), valid & (leaf >= 0)


class _Graphs:
    """One search shape's device work on one searcher, captured as three
    CUDA graphs over static tensors from the bodies the eager path runs:
    ``rank`` (``_rank`` and ``_start``) reads ``q`` and writes ``qp``,
    ``q_sq`` and ``state``; ``score`` (``_score``) reads them and writes
    the chunk's slots and distances; ``merge`` (``_merge``) writes ``out``,
    the state after the chunk.  The three share one memory pool: they
    replay in the order they were captured (rank, score, merge) or as
    score and merge alone, and each reads only tensors that stay alive.  A
    capture runs outside every span and counts no launch."""

    def __init__(self, s: "BatchedSearcher", B: int, D: int, b: int, bi: int, C: int):
        dev = s.device
        self.q = torch.empty((B, D), device=dev)
        self.rank, self.score, self.merge = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        with torch.cuda.device(dev):
            with torch.cuda.graph(self.rank, pool=pool, capture_error_mode="thread_local"):
                self.qp, self.q_sq, self.state = s._start(self.q, s._rank(self.q, bi)[0], C)
            self.w = min(b, self.state.leaf_rank.shape[1])
            with torch.cuda.graph(self.score, pool=pool, capture_error_mode="thread_local"):
                self.leaf_c, self.lvalid, self.d = s._score(self.qp, self.q_sq, self.state, self.w)
            with torch.cuda.graph(self.merge, pool=pool, capture_error_mode="thread_local"):
                self.out = s._merge(self.state, self.leaf_c, self.lvalid, self.d, self.w)


def _owned(out: BatchedQueryState, leaf_rank: torch.Tensor) -> BatchedQueryState:
    """A session's copy of a replay's state ``out``, over its ranked leaves."""
    return BatchedQueryState(leaf_rank, out.next_ptr.clone(), out.buf_d.clone(), out.buf_i.clone())


class BatchedQuery(Query):
    """Handle over the device-resident state of one batched search call."""

    def __init__(self, searcher: "BatchedSearcher", qp: torch.Tensor, q_sq, state: BatchedQueryState,
                 *, b: int, single: bool, graphs: _Graphs | None = None):
        self._searcher = searcher
        self._q = (qp, q_sq)  # the queries as the scan takes them
        self._state = state
        self._b = b
        self._single = single
        self._graphs = graphs  # the search shape's graphs, if it replayed

    @property
    def state(self) -> BatchedQueryState:
        self._ensure_open()
        return self._state

    def next(self, k: int) -> ResultSet:
        self._ensure_open()
        d, i, self._state = self._searcher._advance(*self._q, self._state, k, self._b, self._graphs)
        return self._searcher._result(d, i, self._state, self._single, self)

    def close(self) -> None:
        self._q = None
        self._state = None
        self._graphs = None
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
        self._lock = threading.Lock()  # the graphs: capture, and each replay from copy in to copy out
        self._graphs: dict[tuple, _Graphs] = {}
        self._last = None  # the shape of the last search that asked for graphs
        self._stream = None  # the stream of the last replay

    @property
    def device_bytes(self) -> int:
        """Bytes of the resident packed index on the device (not the CUDA
        graphs' memory pool)."""
        n = self.root.nbytes + self.leaf.nbytes
        n += sum(lv.rows.nbytes + lv.ids.numel() * 8 + lv.mask.numel() for lv in self.levels)
        n += self.leaf_ids.numel() * 8 + self.n_rows.numel() * 4
        return n

    # ------------------------------------------------------------- stage 1
    @torch.no_grad()
    def rank_leaves(self, q: torch.Tensor, b_internal: int):
        """[B, D] queries -> ranked candidate leaves [B, R] (+ distances)."""
        with tracing.span("ecpfs.packed.rank", device=self.device):
            return self._rank(q, b_internal)

    def _rank(self, q: torch.Tensor, b_internal: int):
        """``rank_leaves``' work, outside its span (a capture takes it)."""
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

    def _start(self, q: torch.Tensor, leaf_rank: torch.Tensor, C: int):
        """A search's set-up from its [B, D] queries and ranked leaves ->
        (qp, q_sq, state): the queries prepared for the scan, and the
        state of a zero pointer and empty buffers of C."""
        B = q.shape[0]
        qp, q_sq = _prep_queries(q, self.metric)
        state = BatchedQueryState(
            leaf_rank=leaf_rank,
            next_ptr=torch.zeros((B,), dtype=torch.int64, device=self.device),
            buf_d=torch.full((B, C), torch.inf, device=self.device),
            buf_i=torch.full((B, C), -1, dtype=torch.int64, device=self.device),
        )
        return qp.contiguous(), q_sq, state  # contiguous, as leaf_distances takes it

    # ------------------------------------------------------------- stage 2
    def _score(self, qp: torch.Tensor, q_sq, state: BatchedQueryState, w: int):
        """The next ``w`` ranked leaves of each query and the distances of
        each prepared query to their rows -> (leaf_c [B, w], lvalid [B, w],
        d [B, w, cap]).  The merge masks the rows past each leaf's real
        ones and the slots ``lvalid`` leaves out: neither version of
        ``leaf_distances`` puts a distance there."""
        leaf_c, lvalid = _chunk_slots(state.leaf_rank, state.next_ptr, w)
        d = leaf_distances(qp, q_sq, self.leaf.emb, self.leaf.sq, self.n_rows, leaf_c, lvalid, self.metric)
        return leaf_c, lvalid, d

    def _merge(self, state: BatchedQueryState, leaf_c, lvalid, d, w: int) -> BatchedQueryState:
        """The state after a chunk of ``w`` leaves: its items merged into
        the buffer, the pointer moved past them."""
        buf_d, buf_i = leaf_merge(state.buf_d, state.buf_i, d, self.leaf_ids, self.n_rows, leaf_c, lvalid)
        return BatchedQueryState(state.leaf_rank, state.next_ptr + w, buf_d, buf_i)

    def _count_scored(self, leaf_c: torch.Tensor, lvalid: torch.Tensor) -> None:
        if tracing.enabled():
            tracing.count("ecpfs.packed.rows_scored", rows_scored(leaf_c, lvalid, self.n_rows, self.leaf.emb.shape[1]))

    def _count_needed(self, leaf_c: torch.Tensor, lvalid: torch.Tensor) -> None:
        if tracing.enabled():
            tracing.count("ecpfs.packed.rows_needed", (self.n_rows[leaf_c] * lvalid).sum())

    @torch.no_grad()
    def _scan_chunk(self, qp: torch.Tensor, q_sq, state: BatchedQueryState, w: int,
                    g: _Graphs | None = None) -> BatchedQueryState:
        """Visit the next ``w`` ranked leaves; merge items into the buffer.
        With ``g`` (under the lock, its inputs in place) each stage is a
        replay of its graph, and the state returned is ``g``'s static one."""
        with tracing.span("ecpfs.packed.score", device=self.device):
            if g is None:
                leaf_c, lvalid, d = self._score(qp, q_sq, state, w)
            else:
                g.score.replay()
                leaf_c, lvalid = g.leaf_c, g.lvalid
            self._count_scored(leaf_c, lvalid)
        with tracing.span("ecpfs.packed.merge", device=self.device):
            self._count_needed(leaf_c, lvalid)
            if g is None:
                return self._merge(state, leaf_c, lvalid, d, w)
            g.merge.replay()
        _ld.add_launch()
        _lm.add_launch()
        tracing.count("ecpfs.packed.graph_replays")
        return g.out

    # ------------------------------------------------------- CUDA graphs
    def _graphs_for(self, B: int, D: int, b: int, bi: int, C: int) -> _Graphs | None:
        """The graphs of this search shape, captured when it follows a
        search of the same shape on this searcher; None (run eagerly) on
        the CPU, at a shape's first search in a row and past
        ``GRAPH_SHAPES``."""
        if self.device.type != "cuda" or B == 0:
            return None
        key = (B, b, bi, C)
        with self._lock:
            g = self._graphs.get(key)
            if g is None and key == self._last and len(self._graphs) < GRAPH_SHAPES:
                g = self._graphs[key] = _Graphs(self, B, D, b, bi, C)
                tracing.count("ecpfs.packed.graph_captures")
            self._last = key
            return g

    def _enter_replay(self) -> None:
        """Under the lock: order this replay after the last one when they
        run on different streams (the static tensors are shared)."""
        stream = torch.cuda.current_stream(self.device)
        if self._stream is not None and self._stream != stream:
            stream.wait_stream(self._stream)
        self._stream = stream

    @torch.no_grad()
    def _replay_search(self, g: _Graphs, q: torch.Tensor):
        """Rank ``q`` and scan its first chunk by replay -> (qp, q_sq,
        state), copies the caller owns.  The copies in and out lie outside
        the spans, which time the replays alone."""
        with self._lock, _build.on(self.device):
            self._enter_replay()
            g.q.copy_(q)
            with tracing.span("ecpfs.packed.rank", device=self.device):
                g.rank.replay()
            out = self._scan_chunk(g.qp, g.q_sq, g.state, g.w, g)
            q_sq = None if g.q_sq is None else g.q_sq.clone()
            return g.qp.clone(), q_sq, _owned(out, g.state.leaf_rank.clone())

    @torch.no_grad()
    def _replay_next_chunk(self, g: _Graphs, qp: torch.Tensor, q_sq, state: BatchedQueryState):
        """A further chunk of a session's state by replay, its queries and
        state copied in; the session keeps its own ranked leaves."""
        with self._lock, _build.on(self.device):
            self._enter_replay()
            g.qp.copy_(qp)
            if q_sq is not None:
                g.q_sq.copy_(q_sq)
            for name in ("leaf_rank", "next_ptr", "buf_d", "buf_i"):
                getattr(g.state, name).copy_(getattr(state, name))
            return _owned(self._scan_chunk(g.qp, g.q_sq, g.state, g.w, g), state.leaf_rank)

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
        C = buffer_cap if buffer_cap is not None else max(4 * k, 256)
        graphs = self._graphs_for(B, q.shape[1], b, bi, C)
        if graphs is not None:
            qp, q_sq, state = self._replay_search(graphs, q)
        else:
            leaf_rank, _ = self.rank_leaves(q, bi)
            qp, q_sq, state = self._start(q, leaf_rank, C)
            state = self._scan_chunk(qp, q_sq, state, min(b, leaf_rank.shape[1]))
        d, i, state = self._advance(qp, q_sq, state, k, b, graphs)
        return self._result(d, i, state, single,
                            BatchedQuery(self, qp, q_sq, state, b=b, single=single, graphs=graphs))

    def _advance(self, qp: torch.Tensor, q_sq, state: BatchedQueryState, k: int, b: int,
                 graphs: _Graphs | None = None):
        """Emit the next k items, scanning further leaves if needed (the
        host waits once per loop pass, at the test, and on the CPU once per
        further chunk, at the plain scoring's ``torch.unique``); a chunk
        replays ``graphs`` where given."""
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
                if graphs is not None:
                    state = self._replay_next_chunk(graphs, qp, q_sq, state)
                else:
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
