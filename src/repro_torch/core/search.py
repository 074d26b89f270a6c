"""eCP-FS retrieval: lazy node loading, LRU cache, vectorized incremental
search — the port's counterpart of the reference's ``core/search.py``.

The paper's Algorithms 1-3 behind the ``Searcher`` API (core/api.py):

  * ``ECPIndex.search(q, k, *, b)``  — Algorithm 1 (NewSearch): create the
    per-query state (Q, T, I), run one increment, return the first k items
    in a ``ResultSet`` whose ``.query`` handle owns the state.
  * ``ECPQuery.next(k)``             — Algorithm 2 (GetNextKItems).
  * ``_increment``                   — Algorithm 3: one cross-level
    priority queue T; leaves append scanned items to I; after b leaves,
    either return (|I| >= k) or double b (bounded by mx_inc) and continue.

The traversal, the stores, the exact rerank and the plain leaf scan are
host numpy, copied from the reference so that ``(dists, ids)`` stay bit
for bit the reference's: flat-array frontiers (core/frontier.py), batch
queries advancing in lockstep rounds with cross-query fetch dedup,
multi-probe (``probe_m``), spill dedup, excludes and ``next(k)``.

Two paths run on the device (``device``, "cuda" by default):

  * ``ECPIndex(quantized=True)``: leaf scans read the blob's quantized
    companion blocks (core/quant.py, blob format v3 — an fstore or v2 blob
    encodes on the fly) and every traversal round makes ONE grouped
    distance + top-k launch over all (query, leaf) units of the round
    (kernels/distance_topk, ``grouped_distance_topk``).  The round's codes
    go to the device through one reusable pinned staging buffer, one
    host-to-device copy per round, timed apart from the kernel
    (``ECPIndex.quant_times``).  Survivors whose sound distance lower
    bound could still reach the query's rerank depth
    ``R = max(rerank_depth, emitted + k)`` are re-scored on the host from
    full-precision rows, so emitted results are bit-identical to the fp32
    engine whenever cumulative emissions stay within R.
  * ``make_kernel_scorer()``: a leaf ``scorer`` that sends large leaf
    blocks through the fused ``distance_topk`` kernel (full selection).
    Device float math is not bit-identical to numpy: an opt-in mode
    outside the parity suite.

Not ported yet (ROADMAP Queue 1): ``engine="legacy"``, ``Query.save`` /
``load_query``, ``snapshot()``, prefetch, ``pin_internal``, ``insert``,
``delete`` and ``compact`` — each raises ``NotImplementedError``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from . import layout
from .api import NodeCache, Query, ResultSet, SearchStats, StaleQueryError, pack_rows
from .distances import np_distances
from .frontier import CandidateBuffer, Frontier
from .quant import QFORMATS, distance_bounds, encode_node, qdtype
from .store import NodeNormCache, Store, open_store

__all__ = [
    "ECPIndex",
    "ECPQuery",
    "QueryState",
    "NodeCache",
    "SearchStats",
    "make_kernel_scorer",
]

ENGINES = ("flat",)

# per-query cap on the exact-distance watermark array the quantized scan
# keeps for cross-leaf pruning (QueryState.best_d)
BEST_D_CAP = 4096


def _todo(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 #{item})")


def _kernel_ops():
    """The device top-k entry points, resolved late so the launch-count
    tests can patch ``repro_torch.kernels.distance_topk.ops``."""
    from repro_torch.kernels.distance_topk import ops

    return ops


@dataclass
class QueryState:
    """Persistent per-query state (paper §4.3): Q.q, Q.T, Q.I — T/I as the
    flat-array structures of core/frontier.py."""

    q: np.ndarray
    b: int                   # configured base leaf budget (never mutated)
    mx_inc: int
    exclude: set = field(default_factory=set)
    T: Frontier = field(default_factory=Frontier)
    I: CandidateBuffer = field(default_factory=CandidateBuffer)
    started: bool = False
    increments: int = 0
    emitted: int = 0
    probe_m: int = 1         # frontier pops per traversal step (multi-probe)
    b_cur: int = 0           # transient budget: reset to ``b`` at the start
                             # of every increment, doubled in place of the
                             # old in-place ``qs.b *= 2`` — so a saved or
                             # continued query never runs at an inflated b
    stats: SearchStats = field(default_factory=SearchStats)
    _excl_arr: np.ndarray | None = None
    # quantized-scan bookkeeping: virtual_i mirrors the candidate count
    # the fp32 engine's I would have (scanned live rows minus takes) so
    # control flow stays identical even though only reranked survivors are
    # staged; best_d is the sorted exact-distance watermark used to prune
    # later leaves (None until the first quantized increment)
    virtual_i: int | None = None
    best_d: np.ndarray | None = None
    _q_norm: float | None = None

    def q_norm(self) -> float:
        """||q|| in float64 (the ip metric's error-bound operand)."""
        if self._q_norm is None:
            self._q_norm = float(np.linalg.norm(np.asarray(self.q, np.float64)))
        return self._q_norm

    def excl(self) -> np.ndarray | None:
        """The exclude set as a cached int64 array (np.isin operand).
        The cache lives for one increment (the engine invalidates it on
        entry), so between-call mutations of ``exclude`` are honored just
        like the per-item membership test of the reference's legacy engine."""
        if self._excl_arr is None and self.exclude:
            self._excl_arr = np.fromiter(self.exclude, np.int64, len(self.exclude))
        return self._excl_arr


class _LeafRowCache:
    """Accumulated full-precision rows of one leaf, filled lazily by the
    quantized rerank across rounds and queries.

    ``emb`` is a full-leaf-shaped buffer (rows never fetched stay zero)
    so every rerank GEMM has exactly the shape the fp engine's scan has —
    per-column GEMM results depend only on that column's data, which is
    what keeps staged distances bit-identical.  ``have`` marks which rows
    hold real data; each storage row is read from disk at most once per
    cache residency no matter how many (query, round) units demand it.
    Concurrent fills from snapshot readers write disjoint (or identical)
    rows, so sharing one instance through NodeCache is safe."""

    __slots__ = ("emb", "ids", "have", "born")

    def __init__(self, n_rows: int, dim: int, born: int = 0):
        self.emb = np.zeros((n_rows, dim), np.float32)
        self.ids = np.full(n_rows, -1, np.int64)
        self.have = np.zeros(n_rows, bool)
        self.born = born  # search-call sequence that first demanded rows

    @property
    def nbytes(self) -> int:
        return self.emb.nbytes + self.ids.nbytes + self.have.nbytes


class _PinnedStage:
    """One reusable host staging buffer (page-locked when the device is a
    GPU) and its device twin.  ``begin`` lays out a round's arrays in the
    host buffer and returns numpy views to fill; ``upload`` moves all of
    them with ONE host-to-device copy and returns them as tensors on the
    device (on the CPU, views of the host buffer itself).  Both buffers
    grow geometrically and are never shrunk; the caller reads the results
    of a round (a synchronisation) before it stages the next one."""

    _ALIGN = 256
    _TORCH = {
        np.dtype(np.float32): torch.float32,
        np.dtype(np.int32): torch.int32,
        np.dtype(np.int8): torch.int8,
        np.dtype(np.float16): torch.float16,
    }

    def __init__(self, device: torch.device):
        self.device = device
        self.host = torch.empty(0, dtype=torch.uint8)
        self.dev = torch.empty(0, dtype=torch.uint8, device=device)
        self.nbytes = 0
        self._layout: list = []

    def begin(self, specs: list) -> list:
        layout, at = [], 0
        for shape, dtype in specs:
            dtype = np.dtype(dtype)
            n = int(np.prod(shape)) * dtype.itemsize
            layout.append((at, n, shape, dtype))
            at += -(-n // self._ALIGN) * self._ALIGN
        if self.host.numel() < at:
            size = max(at, 2 * self.host.numel())
            pin = self.device.type == "cuda"
            self.host = torch.empty(size, dtype=torch.uint8, pin_memory=pin)
            if pin:
                self.dev = torch.empty(size, dtype=torch.uint8, device=self.device)
        self.nbytes, self._layout = at, layout
        buf = self.host.numpy()
        return [buf[o : o + n].view(dt).reshape(shape) for o, n, shape, dt in layout]

    def upload(self) -> list:
        src = self.host
        if self.device.type == "cuda":
            self.dev[: self.nbytes].copy_(self.host[: self.nbytes], non_blocking=True)
            src = self.dev
        return [
            src[o : o + n].view(self._TORCH[dt]).view(shape)
            for o, n, shape, dt in self._layout
        ]


def make_kernel_scorer(min_rows: int = 256, bucket: int = 512, *, device="cuda"):
    """A leaf ``scorer`` that runs large leaf blocks through the fused
    ``distance_topk`` kernel on ``device`` and keeps numpy below
    ``min_rows``.

    Full-N selection (k == N) recovers every item's distance, scattered
    back to storage order, so the traversal's candidate semantics are
    unchanged; the kernel takes its distance-only full-selection path for
    it.  Leaf blocks are zero-padded up to the next multiple of ``bucket``
    (pad rows are dropped at the scatter), as in the reference, so one
    launch shape serves every leaf size of a bucket;
    ``scorer.compile_shapes`` is the set of (N_pad, k) shapes issued.
    Device math is NOT guaranteed bit-identical to the numpy path — an
    opt-in mode, excluded from the parity suite.
    """
    if bucket < 1:
        raise ValueError("bucket must be >= 1")
    dev = resolve_device(device)
    compile_shapes: set = set()

    def scorer(q, emb, metric, sqnorms=None):
        n = emb.shape[0]
        if n < min_rows:
            return np_distances(q, emb, metric, c_sqnorms=sqnorms)
        n_pad = -(-n // bucket) * bucket
        block = torch.zeros((n_pad, emb.shape[1]), dtype=torch.float32)
        block[:n] = torch.from_numpy(np.asarray(emb, np.float32))
        qt = torch.from_numpy(np.asarray(q, np.float32).reshape(1, -1))
        compile_shapes.add((n_pad, n_pad))
        d, idx = _kernel_ops().distance_topk(qt.to(dev), block.to(dev), n_pad, metric)
        d, idx = d[0].cpu().numpy(), idx[0].cpu().numpy()
        keep = (idx >= 0) & (idx < n)  # pad rows rank somewhere; full-N selection
        out = np.empty(n, np.float32)  # means every REAL row is present exactly once
        out[idx[keep]] = d[keep]
        return out

    scorer.compile_shapes = compile_shapes
    return scorer


class ECPQuery(Query):
    """Handle over one ``ECPIndex.search`` call (single query or a batch).

    Owns one per-row state; ``next(k)`` resumes the incremental search
    (batch handles resume underflowing rows together, through the same
    round-based dedup engine), ``save()`` persists the frontier into the
    index's own file structure (paper §6.2), ``close()`` frees the states —
    any later call raises ``QueryClosedError`` (no silent ``None`` holes).
    """

    def __init__(self, index: "ECPIndex", states: list, *, single: bool, batch_stats: SearchStats | None = None):
        self._index = index
        self._states = states
        self._single = single
        self._batch_stats = batch_stats
        # a structural rewrite (compact) renumbers nodes; frontiers made
        # before it must not resume over the new tree
        self._epoch = index._epoch

    def _ensure_open(self) -> None:
        super()._ensure_open()
        if self._epoch != self._index._epoch:
            raise StaleQueryError(
                "the index was compacted after this query started; node "
                "references in its frontier are stale — re-issue the search"
            )

    # ------------------------------------------------------------- access
    @property
    def states(self) -> list:
        self._ensure_open()
        return self._states

    @property
    def state(self):
        """The sole state of a single-query handle."""
        self._ensure_open()
        if len(self._states) != 1:
            raise ValueError("state is for single-query handles; use states")
        return self._states[0]

    @property
    def stats(self):
        self._ensure_open()
        if self._single:
            return self._states[0].stats
        return [s.stats for s in self._states]

    @property
    def batch_stats(self) -> SearchStats | None:
        """Aggregate counters of the round-based batch engine (None for
        single-query handles): ``rounds``, actual deduped
        ``node_loads``, ``dedup_hits`` (loads saved by cross-query
        sharing), and the store ``io`` delta of the whole batch."""
        self._ensure_open()
        return self._batch_stats

    @property
    def b(self):
        self._ensure_open()
        if self._single:
            return self._states[0].b
        return [s.b for s in self._states]

    # -------------------------------------------------------- continuation
    def next(self, k: int) -> ResultSet:
        self._ensure_open()
        rows = self._index._next_rows(self._states, k, self._batch_stats)
        return self._index._result(rows, self._states, k, self._single, self)


    def save(self, name: str | None = None, *, group: str = "query_states") -> str:
        raise _todo("Query.save / load_query", "3")

    def close(self) -> None:
        self._states = []
        super().close()



class ECPIndex:
    """Open an eCP-FS file structure for retrieval (the ``Searcher`` for
    file mode: bounded memory, true incremental continuation).

    ``device`` ("cuda" by default; "cpu" only when asked) is where the
    quantized scan's grouped kernel runs; without CUDA, "cuda" raises.
    """

    def __init__(
        self,
        path: "str | Store",
        *,
        backend: str = "auto",
        prefetch: bool = False,
        cache: NodeCache | None = None,
        namespace: str | None = None,
        cache_max_nodes: int | None = None,
        cache_max_bytes: int | None = None,
        engine: str = "flat",
        scorer=None,
        batch_matrix: bool = False,
        norm_cache_entries: int = 16384,
        quantized: "bool | str" = False,
        rerank_depth: int | None = None,
        pin_internal: bool = False,
        probe_m: int = 1,
        device="cuda",
    ):
        if engine == "legacy":
            raise _todo("engine='legacy'", "3")
        if engine not in ENGINES:
            raise ValueError(f"unknown engine: {engine!r} ({'|'.join(ENGINES)})")
        if prefetch:
            raise _todo("prefetch", "2")
        if pin_internal:
            raise _todo("pin_internal", "3")
        if isinstance(quantized, str) and quantized not in QFORMATS:
            raise ValueError(
                f"unknown quant format: {quantized!r} ({'|'.join(QFORMATS)})"
            )
        self.device = resolve_device(device)
        self._owns_store = not isinstance(path, Store)
        self.store = path if isinstance(path, Store) else open_store(path, backend=backend)
        attrs = self.store.read_attrs(layout.INFO)
        self.info = layout.IndexInfo.from_attrs(attrs)
        self._tombstones: set = layout.read_tombstones(attrs)
        self._tomb_arr: np.ndarray | None = None
        self._epoch = 0
        self._node_ver: dict[tuple[int, int], int] = {}
        # Loading the index = read info + the root node only (paper §4.2).
        self.root_emb, self.root_ids = self.store.get_node(0, 0)
        self.cache = cache if cache is not None else NodeCache(
            cache_max_nodes, max_bytes=cache_max_bytes
        )
        # namespace tag keeps keys distinct inside a shared cache
        self._ns = namespace if namespace is not None else str(self.store.path)
        self.load_node_count = 0
        self.engine = engine
        self._scorer = scorer
        self._batch_matrix = bool(batch_matrix)
        # per-node squared-norm cache: l2 reuses (c*c).sum(-1) directly and
        # cosine takes np.sqrt of it — bitwise what np.linalg.norm computes
        self._norms = (
            NodeNormCache(norm_cache_entries)
            if self.info.metric in ("l2", "cosine")
            else None
        )
        # device-resident scoring pipeline (quantized leaf scan + rerank):
        # qformat follows the blob's persisted companion tier; a string
        # ``quantized`` overrides it for on-the-fly encoding backends
        self._quantized = bool(quantized)
        self._rerank_depth = None if rerank_depth is None else max(1, int(rerank_depth))
        # monotone per-public-call counter: a leaf whose row cache was
        # born in an EARLIER call is under repeat demand, so later calls
        # read it whole and scan it on the cached fp fast path
        self._quant_seq = 0
        self._qformat = (
            quantized
            if isinstance(quantized, str)
            else (getattr(self.store, "quant_format", None) or "int8")
        )
        # multi-probe traversal default (per-call ``probe_m=`` overrides)
        self._probe_m = max(1, int(probe_m))
        self._stage = _PinnedStage(self.device)
        # the quantized scan's time, summed over rounds: filling the staging
        # buffer and the rerank on the host clock, the codes' host-to-device
        # copy and the kernel on CUDA events (CUDA only; zero on the CPU)
        self.quant_times = {
            "rounds": 0, "h2d_bytes": 0, "stage_ms": 0.0, "h2d_ms": 0.0,
            "kernel_ms": 0.0, "rerank_ms": 0.0,
        }

    # ------------------------------------------------------------ node IO
    def _key(self, level: int, node: int) -> tuple:
        """Versioned cache key: (namespace, epoch, node-version, level,
        node).  Mutations bump the node's version (or the epoch, for
        structural rewrites), so an ``ECPSnapshot`` pinned at an older
        (epoch, version) and the live index can share one ``NodeCache``
        without ever seeing each other's bytes."""
        return (self._ns, self._epoch, self._node_ver.get((level, node), 0), level, node)

    def _store_miss(self, level: int, node: int, v) -> None:
        """Account + cache one node read the store just served (internal
        levels 1..L-1 bump ``io.internal_reads``)."""
        self.load_node_count += 1
        if 0 < level < self.info.levels:
            self.store.io.count_internal(1)
        self.cache.put(self._key(level, node), v)

    def get_node(self, level: int, node: int) -> tuple[np.ndarray, np.ndarray]:
        v = self.cache.get(self._key(level, node))
        if v is not None:
            return v
        v = self.store.get_node(level, node)
        self._store_miss(level, node, v)
        return v

    def get_nodes(self, keys: list) -> list:
        """Cache-aware batched node read (one ``Store.get_nodes`` for the
        misses, so a blob backend can coalesce adjacent blocks)."""
        out: list = [None] * len(keys)
        missing, missing_i = [], []
        for i, (lv, nd) in enumerate(keys):
            v = self.cache.get(self._key(lv, nd))
            if v is not None:
                out[i] = v
            else:
                missing.append((lv, nd))
                missing_i.append(i)
        if missing:
            for (lv, nd), i, v in zip(missing, missing_i, self.store.get_nodes(missing)):
                self._store_miss(lv, nd, v)
                out[i] = v
        return out

    def _get_quant_nodes(self, keys: list) -> list:
        """Cache-aware batched read of the leaves' quantized companion
        blocks (``QuantNode`` per key, cached under ``key + ('q',)``).
        A store without companions (fstore, v1/v2 blob) falls back to
        encoding the full-precision node on the fly — functionally
        identical, no byte savings."""
        out: list = [None] * len(keys)
        missing, missing_i = [], []
        for i, (lv, nd) in enumerate(keys):
            v = self.cache.get(self._key(lv, nd) + ("q",))
            if v is not None:
                out[i] = v
            else:
                missing.append((lv, nd))
                missing_i.append(i)
        if missing:
            getter = getattr(self.store, "get_nodes_quantized", None)
            if getter is not None:
                payloads = getter(missing, self._qformat)
            else:
                payloads = [
                    encode_node(self.store.get_node(lv, nd)[0], self._qformat)
                    for lv, nd in missing
                ]
            for (lv, nd), i, qn in zip(missing, missing_i, payloads):
                self.load_node_count += 1
                self.cache.put(self._key(lv, nd) + ("q",), qn)
                out[i] = qn
        return out

    def _get_leaf_ids(self, level: int, node: int) -> np.ndarray:
        """One leaf's item ids without its embeddings (tombstone/exclude
        filtering during the quantized scan): served from a cached full
        node when resident, else an ids-only store read cached under
        ``key + ('ids',)``."""
        full = self.cache.get(self._key(level, node))
        if full is not None:
            return full[1]
        ikey = self._key(level, node) + ("ids",)
        v = self.cache.get(ikey)
        if v is not None:
            return v
        getter = getattr(self.store, "get_node_ids", None)
        ids = getter(level, node) if getter is not None else self.store.get_node(level, node)[1]
        self.cache.put(ikey, ids)
        return ids

    def close(self) -> None:
        """Close the underlying store if this index opened it.  Idempotent."""
        if self._owns_store and self.store is not None:
            self.store.close()

    def __enter__(self) -> "ECPIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------- not ported yet
    def insert(self, vectors, ids=None) -> dict:
        raise _todo("insert", "5")

    def delete(self, ids) -> int:
        raise _todo("delete", "5")

    def compact(self) -> dict:
        raise _todo("compact", "5")

    def snapshot(self):
        raise _todo("snapshot()", "2")

    def prefetch(self, up_to_level: int) -> None:
        raise _todo("prefetch", "2")

    def load_query(self, name: str, *, group: str = "query_states") -> ECPQuery:
        raise _todo("Query.save / load_query", "3")

    supports_snapshot = False

    @property
    def tombstones(self) -> set:
        """Tombstoned item ids (a copy; mutate via ``delete``)."""
        return set(self._tombstones)

    @property
    def generation(self) -> int:
        return self.info.generation

    def _tomb_sorted(self) -> np.ndarray | None:
        """Tombstones as a cached sorted array (np.isin operand)."""
        if not self._tombstones:
            return None
        if self._tomb_arr is None or len(self._tomb_arr) != len(self._tombstones):
            self._tomb_arr = np.sort(
                np.fromiter(self._tombstones, np.int64, len(self._tombstones))
            )
        return self._tomb_arr

    # ------------------------------------------------------------ scoring
    def _sqnorms(self, level: int, node: int, emb: np.ndarray) -> np.ndarray | None:
        if self._norms is None or len(emb) == 0:
            return None
        return self._norms.get(level, node, emb)

    def _score_row(self, q: np.ndarray, emb: np.ndarray, sq, *, leaf: bool) -> np.ndarray:
        """One row's distances to one node — the exact ``[1, D]`` numpy
        call of the reference engine unless a custom leaf scorer is set."""
        if leaf and self._scorer is not None:
            return self._scorer(q, emb, self.info.metric, sq)
        return np_distances(q, emb, self.info.metric, c_sqnorms=sq)

    def _stage_leaf(
        self, qs: QueryState, d: np.ndarray, ids: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        tomb = self._tomb_sorted()
        if tomb is not None and len(ids):
            keep = ~np.isin(ids, tomb)
            if not keep.all():
                d, ids = d[keep], ids[keep]
        if qs.exclude:
            keep = ~np.isin(ids, qs.excl())
            if not keep.all():
                d, ids = d[keep], ids[keep]
        qs.I.stage(d, ids)
        return d, ids

    def _ilen(self, qs: QueryState) -> int:
        """The candidate count Algorithm 2/3 decisions key off: the fp32
        engines use ``len(I)`` directly; the quantized scan substitutes
        the virtual count (all scanned live rows, not just the reranked
        survivors it stages) so traversal control flow is identical."""
        return qs.virtual_i if qs.virtual_i is not None else len(qs.I)

    def _fp_leaf(self, key: tuple) -> bool:
        """Quantized-mode routing: scan this leaf full-precision when its
        fp node is already cached, or when its rerank row cache was born
        in an earlier public call (repeat demand across calls — one full
        read now converges the leaf to plain-scan speed)."""
        if self.cache.contains(self._key(*key)):
            return True
        rc = self.cache.get(self._key(*key) + ("rows",))
        return rc is not None and rc.born < self._quant_seq

    @staticmethod
    def _note_exact(qs: QueryState, d_live) -> None:
        """Fold freshly-staged exact live distances into the query's
        sorted cross-leaf watermark (``best_d``) used by the quantized
        scan's rank-R pruning threshold."""
        if not len(d_live):
            return
        add = np.asarray(d_live, np.float64)
        bd = qs.best_d
        merged = add if bd is None else np.concatenate([bd, add])
        merged.sort()
        qs.best_d = merged[:BEST_D_CAP]


    # ------------------------------------------------------- Algorithm 1
    def search(
        self,
        q: np.ndarray,
        k: int = 100,
        *,
        b: int | None = 8,
        mx_inc: int = 4,
        exclude: set | None = None,
        probe_m: int | None = None,
    ) -> ResultSet:
        """New search over one vector [D] or a batch [B, D].

        Returns a ``ResultSet``; ``.query`` is the ``ECPQuery`` handle for
        ``next(k)`` continuation, ``save()``, and ``close()``.  Batch
        queries traverse in lockstep rounds with cross-query node-fetch
        dedup (``.query.batch_stats``).

        ``probe_m`` overrides the index's multi-probe width for this
        query: each traversal step pops the top-``probe_m`` frontier
        entries instead of just the single best, widening descent (and,
        past the leaf-budget boundary, scanning up to ``probe_m - 1``
        extra leaves) for higher recall at the same ``b``.  ``probe_m=1``
        (the default) is bit-identical to strict best-first traversal.
        """
        b = 8 if b is None else int(b)
        pm = self._probe_m if probe_m is None else max(1, int(probe_m))
        q = np.asarray(q, np.float32)
        single = q.ndim == 1
        Q = q[None, :] if single else q
        excl = set(exclude) if exclude else set()
        states = [
            QueryState(q=row, b=b, mx_inc=mx_inc, exclude=set(excl), probe_m=pm)
            for row in Q
        ]
        if self.info.spill_s > 0:
            # spill-built index: a vector may live in several leaves —
            # id-level dedup at emission keeps next(k) duplicate-free
            for qs in states:
                qs.I.dedup = True
        self._quant_seq += 1
        if len(states) == 1:
            self._increment(states[0], k)
            rows = [self._next_items(states[0], k)]
            return self._result(rows, states, k, single, ECPQuery(self, states, single=single))
        # batch: initial increment, then one resume pass for underflowing
        # rows — the same two chances Algorithm 1 + 2 give a single query
        agg = SearchStats()
        self._batch_increment(states, k, agg)
        need = [qs for qs in states if self._ilen(qs) < k and qs.T]
        if need:
            self._batch_increment(need, k, agg)
        rows = [self._next_items(qs, k, resume=False) for qs in states]
        return self._result(
            rows, states, k, single, ECPQuery(self, states, single=single, batch_stats=agg)
        )

    def _result(self, rows, states, k, single, query) -> ResultSet:
        d, i = pack_rows([r[0] for r in rows], [r[1] for r in rows], k)
        if single:
            return ResultSet(dists=d[0], ids=i[0], stats=states[0].stats, query=query)
        return ResultSet(dists=d, ids=i, stats=[s.stats for s in states], query=query)

    # ------------------------------------------------------- Algorithm 2
    def _next_rows(self, states: list, k: int, batch_stats: SearchStats | None = None) -> list:
        self._quant_seq += 1
        if len(states) > 1:
            need = [qs for qs in states if self._ilen(qs) < k and qs.T]
            if need:
                agg = batch_stats if batch_stats is not None else SearchStats()
                self._batch_increment(need, k, agg)
            return [self._next_items(qs, k, resume=False) for qs in states]
        return [self._next_items(qs, k) for qs in states]

    def _next_items(self, qs: QueryState, k: int, *, resume: bool = True):
        if resume and self._ilen(qs) < k and qs.T:
            self._increment(qs, k)
        d, i = qs.I.take(k)
        qs.emitted += int(len(d))
        if qs.virtual_i is not None:
            qs.virtual_i = max(0, qs.virtual_i - int(len(d)))
        return d, i

    # ------------------------------------------------------- Algorithm 3
    def _start(self, qs: QueryState) -> None:
        qs.started = True
        d = np_distances(qs.q, self.root_emb, self.info.metric)
        qs.stats.distance_calcs += len(self.root_emb)
        qs.T.push_batch(d, self.root_ids, 1 if self.info.levels == 1 else 0, 1)

    def _increment(self, qs: QueryState, k: int) -> None:
        if self._quantized:
            # the quantized scan lives in the round engine (it is what
            # builds the per-round grouped kernel launch) — a single query
            # is a batch of one, with io/launches re-attributed to the row
            io_before = self.store.io.snapshot()
            agg = SearchStats()
            self._batch_increment([qs], k, agg)
            qs.stats.kernel_launches += agg.kernel_launches
            qs.stats.io.add(self.store.io.delta(io_before))
            return
        info = self.info
        leaf_cnt = 0
        qs.b_cur = qs.b  # each increment starts from the configured budget
        loads_before = self.load_node_count
        io_before = self.store.io.snapshot()
        qs._excl_arr = None  # re-read the (mutable) exclude set

        if not qs.started:
            self._start(qs)

        # Each step pops a probe group — the top-min(probe_m, |T|) frontier
        # entries taken BEFORE any of them is expanded (children pushed by
        # the group land in the next group, exactly one batch-engine round).
        # Budget checks stay inline per leaf but only break at the group
        # boundary, so a group may stage up to probe_m - 1 leaves past the
        # stopping point — that overshoot is the recall widening.
        # probe_m=1 is exactly the old single-pop loop.
        while qs.T:
            stop = False
            group = [qs.T.pop() for _ in range(min(qs.probe_m, len(qs.T)))]
            for dist, is_leaf, level, node in group:
                qs.stats.nodes_opened += 1
                emb, ids = self.get_node(level, node)
                if len(ids) == 0:
                    continue
                d = self._score_row(qs.q, emb, self._sqnorms(level, node, emb), leaf=bool(is_leaf))
                qs.stats.distance_calcs += len(ids)
                if is_leaf:
                    qs.stats.leaves_opened += 1
                    self._stage_leaf(qs, d, ids)
                    leaf_cnt += 1
                else:
                    qs.T.push_batch(d, ids, 1 if (level + 1) == info.levels else 0, level + 1)
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
        qs.stats.node_loads += self.load_node_count - loads_before
        # NOTE: with an AsyncPrefetchStore, background reads count when they
        # complete, so per-traversal io can lag slightly; store.drain() gives
        # exact attribution (benchmarks use it between passes)
        qs.stats.io.add(self.store.io.delta(io_before))
        qs.I.commit()

    # --------------------------------------------- Algorithm 3, batch mode
    def _batch_increment(self, states: list, k: int, agg: SearchStats) -> None:
        """Advance every row's traversal in lockstep rounds.

        Each round pops one node demand per active row, dedupes the
        demands, and issues a single cache-aware ``get_nodes`` so the blob
        backend coalesces adjacent blocks and a node wanted by several
        rows is read once.  Per-row control flow (leaf budget, b-doubling,
        termination) is exactly Algorithm 3, so results are bit-identical
        to independent single-query traversals.

        Stats: each row keeps its own nodes_opened / distance_calcs /
        leaves_opened / increments / rounds, and counts ``node_loads`` as
        the misses *it* demanded (what a solo run would have read) with
        ``dedup_hits`` for demands served by another row's load in the
        same round.  ``agg`` gets the actual deduped loads, total rounds,
        total dedup savings, and the store io delta of the whole call
        (per-row ``stats.io`` stays zero in batch mode — coalesced reads
        have no per-row attribution).
        """
        info = self.info
        quant = self._quantized
        io_before = self.store.io.snapshot()
        for qs in states:
            qs._excl_arr = None  # re-read the (mutable) exclude set
            qs.b_cur = qs.b  # each increment starts from the configured budget
            if not qs.started:
                self._start(qs)
            if quant and qs.virtual_i is None:
                qs.virtual_i = len(qs.I)
        leaf_cnt = {id(qs): 0 for qs in states}
        pending: list = []  # quantized (query, leaf) units awaiting rerank
        active = [qs for qs in states if qs.T]
        while active:
            agg.rounds += 1
            pops = []
            for qs in active:
                # multi-probe: each round takes the row's top-probe_m
                # frontier entries (probe_m=1 = the old single pop), so
                # the round's dedup/coalescing window widens with m
                for _ in range(min(qs.probe_m, len(qs.T))):
                    d0, is_leaf, level, node = qs.T.pop()
                    qs.stats.nodes_opened += 1
                    pops.append((qs, is_leaf, level, node))
                qs.stats.rounds += 1
            # cross-query fetch dedup: unique (level, node) demands, one
            # batched read for all of them
            key_rows: dict[tuple, list] = {}
            for p in pops:
                key_rows.setdefault((p[2], p[3]), []).append(p)
            keys = list(key_rows)
            # quantized mode scans leaves from the compressed companion
            # blocks; only internal nodes go through the fp payload path.
            # A leaf whose full fp node is already cached (a prior rerank
            # fetched it), or whose row cache was born in an earlier call
            # (repeat demand — read it whole once, scan it cheap forever),
            # skips the kernel + rerank entirely and scans through the fp
            # path — the results are bit-identical either way, and the
            # warm path costs what the plain engine's does.
            if quant:
                leaf_keys = [
                    key
                    for key in keys
                    if key_rows[key][0][1] and not self._fp_leaf(key)
                ]
                lset = set(leaf_keys)
                fp_keys = [key for key in keys if key not in lset]
            else:
                leaf_keys, fp_keys = [], keys
            missing = {
                key for key in fp_keys if not self.cache.contains(self._key(*key))
            }
            missing |= {
                key
                for key in leaf_keys
                if not self.cache.contains(self._key(*key) + ("q",))
            }
            payloads = dict(zip(fp_keys, self.get_nodes(fp_keys))) if fp_keys else {}
            qpayloads = (
                dict(zip(leaf_keys, self._get_quant_nodes(leaf_keys)))
                if leaf_keys
                else {}
            )
            for key in keys:
                demanders = key_rows[key]
                if key in missing:
                    agg.node_loads += 1
                    agg.dedup_hits += len(demanders) - 1
                    for j, p in enumerate(demanders):
                        p[0].stats.node_loads += 1
                        if j:
                            p[0].stats.dedup_hits += 1
            done: set[int] = set()
            if leaf_keys:
                self._quant_scan_round(
                    leaf_keys, key_rows, qpayloads, k, agg, leaf_cnt, done, pending
                )
            for key in fp_keys:
                emb, ids = payloads[key]
                if len(ids) == 0:
                    continue
                level, node = key
                demanders = key_rows[key]
                is_leaf = bool(demanders[0][1])
                sq = self._sqnorms(level, node, emb)
                D = None
                if self._batch_matrix and len(demanders) >= 4 and not (is_leaf and (self._scorer is not None or quant)):
                    # opt-in dense [B', N] block (not bit-exact across B');
                    # only pays off once enough rows co-demand the node
                    D = np_distances(
                        np.stack([p[0].q for p in demanders]), emb, info.metric, c_sqnorms=sq
                    )
                for r, (qs, _, _, _) in enumerate(demanders):
                    d = D[r] if D is not None else self._score_row(
                        qs.q, emb, sq, leaf=is_leaf and not quant
                    )
                    qs.stats.distance_calcs += len(ids)
                    if is_leaf:
                        qs.stats.leaves_opened += 1
                        d_f, _ = self._stage_leaf(qs, d, ids)
                        if qs.virtual_i is not None:
                            # a fully-staged leaf advances the virtual
                            # count by its live rows, and its exact
                            # distances tighten the cross-leaf watermark
                            qs.virtual_i += int(len(d_f))
                            self._note_exact(qs, d_f)
                        leaf_cnt[id(qs)] += 1
                        if leaf_cnt[id(qs)] >= qs.b_cur:
                            if self._ilen(qs) >= k:
                                done.add(id(qs))
                            elif qs.mx_inc == -1 or qs.increments < qs.mx_inc:
                                qs.increments += 1
                                qs.stats.increments += 1
                                qs.b_cur *= 2
                            else:
                                done.add(id(qs))
                    else:
                        qs.T.push_batch(d, ids, 1 if (level + 1) == info.levels else 0, level + 1)
            active = [qs for qs in active if id(qs) not in done and qs.T]
        t0 = time.perf_counter()
        self._quant_finalize(pending)
        self.quant_times["rerank_ms"] += (time.perf_counter() - t0) * 1e3
        agg.io.add(self.store.io.delta(io_before))
        for qs in states:
            qs.I.commit()

    # ------------------------------------------- quantized leaf scan round
    def _quant_scan_round(
        self, leaf_keys, key_rows, qpayloads, k, agg, leaf_cnt, done, pending
    ) -> None:
        """Scan every (query, leaf) unit of one traversal round from the
        quantized companion blocks with ONE grouped device launch.

        Only the approximate results are produced here — they go on
        ``pending`` and are reranked once, at the end of the increment
        (``_quant_finalize``), when every scanned leaf's upper bounds have
        been seen and the per-query pruning watermark is as tight as it
        will get.  Traversal control flow never looks at staged leaf
        distances (only at the virtual candidate count and the internal
        levels), so deferring the rerank cannot change which nodes are
        visited."""
        info = self.info
        metric = info.metric
        tomb = self._tomb_sorted()
        units = []  # (qs, key, qn, R)
        for key in leaf_keys:
            qn = qpayloads[key]
            if qn.n_rows == 0:
                continue  # matches the fp engines: empty nodes cost nothing
            for qs, _leaf, _lv, _nd in key_rows[key]:
                units.append(
                    (qs, key, qn, max(self._rerank_depth or 0, qs.emitted + k))
                )
        if not units:
            return
        # ---- the round's single grouped kernel launch
        G = len(units)
        n_max = max(u[2].n_rows for u in units)
        r_max = max(u[3] for u in units)
        kop = min(n_max, -(-(r_max + 16) // 32) * 32)
        # every input of the launch is written straight into the staging
        # buffer and goes to the device in one copy
        t0 = time.perf_counter()
        q_arr, codes, scales, offsets, n_rows = self._stage.begin([
            ((G, info.dim), np.float32),
            ((G, n_max, info.dim), qdtype(self._qformat)),
            ((G,), np.float32),
            ((G,), np.float32),
            ((G,), np.int32),
        ])
        for g, (qs, key, qn, R) in enumerate(units):
            q_arr[g] = qs.q
            codes[g, : qn.n_rows] = qn.codes
            codes[g, qn.n_rows :] = 0
            scales[g] = qn.scale
            offsets[g] = qn.offset
            n_rows[g] = qn.n_rows
        t = self.quant_times
        t["stage_ms"] += (time.perf_counter() - t0) * 1e3
        t["rounds"] += 1
        t["h2d_bytes"] += self._stage.nbytes
        timed = self.device.type == "cuda"
        if timed:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
        args = self._stage.upload()
        if timed:
            ev[1].record()
        d_t, i_t = _kernel_ops().grouped_distance_topk_tensors(
            *args, kop, metric, self._qformat
        )
        if timed:
            ev[2].record()
        dists, idxs = d_t.cpu().numpy(), i_t.cpu().numpy()
        agg.kernel_launches += 1
        if timed:
            t["h2d_ms"] += ev[0].elapsed_time(ev[1])
            t["kernel_ms"] += ev[1].elapsed_time(ev[2])
        # ---- record approximate results; advance per-query control flow
        for g, (qs, key, qn, R) in enumerate(units):
            dead_rows = None
            n_dead = 0
            if tomb is not None or qs.exclude:
                ids = self._get_leaf_ids(*key)
                dead = np.zeros(len(ids), bool)
                if tomb is not None:
                    dead |= np.isin(ids, tomb)
                if qs.exclude:
                    dead |= np.isin(ids, qs.excl())
                dead_rows = np.flatnonzero(dead)
                n_dead = len(dead_rows)
            valid = idxs[g] >= 0
            pending.append(
                (
                    qs,
                    key,
                    qn,
                    R,
                    dists[g][valid].astype(np.float64),
                    idxs[g][valid].astype(np.int64),
                    qn.n_rows > kop,
                    dead_rows,
                )
            )
            qs.stats.distance_calcs += qn.n_rows
            qs.stats.leaves_opened += 1
            # virtual candidate count advances by what the fp engine would
            # have staged: every live row of the leaf, survivors or not
            qs.virtual_i += qn.n_rows - n_dead
            leaf_cnt[id(qs)] += 1
            if leaf_cnt[id(qs)] >= qs.b_cur:
                if qs.virtual_i >= k:
                    done.add(id(qs))
                elif qs.mx_inc == -1 or qs.increments < qs.mx_inc:
                    qs.increments += 1
                    qs.stats.increments += 1
                    qs.b_cur *= 2
                else:
                    done.add(id(qs))

    def _quant_finalize(self, pending) -> None:
        """End-of-increment rerank of every pending (query, leaf) unit.

        Pass 1 live-filters each unit and pools its exact-distance upper
        bounds per query; the R-th smallest pooled value (together with
        ``best_d``, the exact distances staged by earlier increments) is a
        sound bound on the query's R-th best distance — at least R
        distinct rows provably score at or below it.  Pass 2 keeps only
        rows whose lower bound could still reach rank R under that final
        watermark, then fetches and scores the survivors.

        A fully-pruned leaf never touches its fp block — that is the
        scan's byte saving.  Already-cached or high-coverage leaves go
        through ONE coalescing ``get_nodes`` (which populates the node
        cache, so later increments scan them on the cached fp fast path);
        sparse survivor sets use partial row reads (I/O proportional to
        R, not the leaf size) accumulated in a per-leaf _LeafRowCache —
        each storage row is read from disk at most once no matter how
        many queries or increments demand it.  The row cache keeps the
        full leaf shape so every scoring GEMM below has exactly the shape
        the fp engine's has, and a GEMM's per-column results depend only
        on that column's data — so staged distances stay bit-identical (a
        subset-shaped GEMM would drift in the last ulp)."""
        if not pending:
            return
        info = self.info
        metric = info.metric
        # ---- pass 1: live-filter, bounds, per-query upper-bound pool
        prep = []
        pools: dict[int, list] = {}
        rank: dict[int, int] = {}
        for qs, key, qn, R, d_sorted, i_sorted, truncated, dead_rows in pending:
            if dead_rows is not None and len(dead_rows) and len(i_sorted):
                live = ~np.isin(i_sorted, dead_rows)
                d_live, i_live = d_sorted[live], i_sorted[live]
            else:
                d_live, i_live = d_sorted, i_sorted
            q_norm = qs.q_norm() if metric == "ip" else 0.0
            if len(d_live):
                lb, ub = distance_bounds(d_live, qn.radius, metric, q_norm)
                pools.setdefault(id(qs), []).append(ub)
            else:
                lb = ub = None
            rank[id(qs)] = max(rank.get(id(qs), 0), R)
            prep.append(
                (qs, key, qn, R, d_sorted, d_live, i_live, lb, ub, truncated, dead_rows)
            )
        tau_state: dict[int, float] = {}
        for qs, key, qn, R, *_ in prep:
            qid = id(qs)
            if qid in tau_state:
                continue
            vals = pools.get(qid, [])
            if qs.best_d is not None:
                vals = vals + [qs.best_d]
            R = rank[qid]
            if vals:
                u = np.concatenate(vals)
                u.sort()
                tau_state[qid] = float(u[R - 1]) if len(u) >= R else np.inf
            else:
                tau_state[qid] = np.inf
        # ---- pass 2: survivors per unit under the final watermark
        need_rows: dict[tuple, list] = {}
        selections = []  # (qs, key, qn, rows)
        for qs, key, qn, R, d_sorted, d_live, i_live, lb, ub, truncated, dead_rows in prep:
            q_norm = qs.q_norm() if metric == "ip" else 0.0
            rows, overflow = self._quant_survivors(
                d_live, i_live, lb, ub, d_sorted, truncated,
                qn.radius, R, tau_state[id(qs)], q_norm, metric,
            )
            if overflow:
                # rescore the whole leaf from the local codes on the host
                d_all = np_distances(qs.q, qn.decode(), metric).astype(np.float64)
                order = np.argsort(d_all, kind="stable").astype(np.int64)
                if dead_rows is not None and len(dead_rows):
                    live = ~np.isin(order, dead_rows)
                    d_l, i_l = d_all[order][live], order[live]
                else:
                    d_l, i_l = d_all[order], order
                lb2 = ub2 = None
                if len(d_l):
                    lb2, ub2 = distance_bounds(d_l, qn.radius, metric, q_norm)
                rows, _ = self._quant_survivors(
                    d_l, i_l, lb2, ub2, d_all, False,
                    qn.radius, R, tau_state[id(qs)], q_norm, metric,
                )
            selections.append((qs, key, qn, rows))
            if len(rows):
                need_rows.setdefault(key, []).append(rows)
        # ---- survivor fetch: one coalescing full read + row-cache top-ups
        partial_getter = getattr(self.store, "get_node_rows", None)
        unions: dict[tuple, np.ndarray] = {}
        full_keys: list = []
        plans: dict[tuple, tuple] = {}  # key -> (rkey, row_cache, missing)
        n_of = {key: qn.n_rows for _, key, qn, _ in selections}
        for key, row_lists in need_rows.items():
            union = (
                row_lists[0]
                if len(row_lists) == 1
                else np.unique(np.concatenate(row_lists))
            )
            unions[key] = union
            if partial_getter is None or self.cache.contains(self._key(*key)):
                full_keys.append(key)
                continue
            rkey = self._key(*key) + ("rows",)
            rc = self.cache.get(rkey)
            missing = union if rc is None else union[~rc.have[union]]
            # with contiguous-only run merging a partial fetch never reads
            # a byte it doesn't need, so a full-node read only wins (on
            # syscalls) when literally every row is demanded
            if rc is None and len(missing) >= n_of[key]:
                full_keys.append(key)
            else:
                plans[key] = (rkey, rc, missing)
        full_payloads = (
            dict(zip(full_keys, self.get_nodes(full_keys))) if full_keys else {}
        )
        fetched: dict[tuple, tuple] = {}
        for key, union in unions.items():
            if key in full_payloads:
                emb, ids = full_payloads[key]
                fetched[key] = (emb, self._sqnorms(*key, emb), ids)
            else:
                rkey, rc, need = plans[key]
                if rc is None:
                    rc = _LeafRowCache(n_of[key], info.dim, self._quant_seq)
                if len(need):
                    emb_rows, ids_rows = partial_getter(*key, need)
                    rc.emb[need] = emb_rows
                    rc.ids[need] = ids_rows
                    rc.have[need] = True
                    if rc.have.all():
                        # the accumulated rows ARE the node (same f32 cast
                        # as get_node) — promote to the node cache so the
                        # leaf scans on the fp fast path from now on
                        self.cache.put(self._key(*key), (rc.emb, rc.ids))
                    else:
                        self.cache.put(rkey, rc)
                fetched[key] = (rc.emb, None, rc.ids)
        # ---- exact scoring + staging, per unit
        for qs, key, qn, rows in selections:
            if not len(rows):
                continue
            emb, sq, ids = fetched[key]
            d_full = np_distances(qs.q, emb, metric, c_sqnorms=sq)
            d_live, _ = self._stage_leaf(qs, d_full[rows], ids[rows])
            self._note_exact(qs, d_live)

    @staticmethod
    def _quant_survivors(
        d_live, i_live, lb, ub, d_sorted, truncated, radius, R, tau_state,
        q_norm, metric,
    ) -> tuple[np.ndarray, bool]:
        """Rows of one scanned leaf that must be reranked: every live row
        whose exact-distance lower bound could still reach rank ``R``.

        ``d_live``/``i_live``/``lb``/``ub`` are the unit's live
        approximate distances (ascending), storage rows, and exact-
        distance bounds; ``d_sorted`` is the unfiltered approx list (its
        tail bounds the unseen rows); ``tau_state`` is the query's pooled
        cross-leaf watermark.  Returns (survivor rows ascending,
        overflow): overflow means pruning the unseen tail past a
        truncated kernel list could not be proven sound and the caller
        must rescore the whole leaf from the local codes (no extra
        I/O)."""
        if len(d_live) == 0:
            return i_live, bool(truncated)
        Rp = min(R, len(d_live))
        # ub is ascending (monotone in the approx distance), so the Rp-th
        # smallest live upper bound closes the leaf-local threshold; the
        # cross-leaf watermark can only tighten it
        tau = min(float(ub[Rp - 1]), tau_state)
        # slack absorbs device-vs-host float drift in approx distances
        # (f32 kernel vs f64 host bounds: relative error ~1e-6)
        tau_eff = tau + 1e-4 * abs(tau) + 1e-7
        rows = np.sort(i_live[lb <= tau_eff])
        if truncated:
            # unseen rows all score >= the largest seen approx distance;
            # prunable only if even that lower bound clears tau
            lb_tail = distance_bounds(d_sorted[-1:], radius, metric, q_norm)[0][0]
            if len(d_live) < R or lb_tail <= tau_eff:
                return rows, True
        return rows, False

