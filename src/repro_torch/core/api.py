"""The retrieval API the port's searcher speaks (copy of the reference's
``core/api.py`` for file mode).

  * ``Searcher``   — protocol: ``search(q, k, *, b) -> ResultSet``.
  * ``ResultSet``  — ``dists``/``ids`` numpy arrays (``[k]`` for a single
    query, ``[B, k]`` for a batch; short result lists are padded with
    ``+inf``/``-1``), per-query ``SearchStats``, and the ``Query`` handle
    that owns the incremental state.
  * ``Query``      — handle with ``.next(k)`` (more results), ``.save()``
    (persist the frontier into the index's own file structure, eCP-FS
    only), and ``.close()``; a closed handle raises ``QueryClosedError``.
  * ``RestartQuery`` — the continuation for searchers without native
    incremental state: ``.next(k)`` re-searches with ``emitted + k`` and
    returns the tail (the paper's restart protocol for IVF/HNSW/DiskANN).
  * ``MutableIndex`` — protocol of a searcher whose index mutates while
    serving (``insert`` / ``delete`` / ``compact``).
  * ``open_index(path, mode="file"|"packed"|"auto")`` — the file-structure
    searcher (``ECPIndex``) or the device-resident one
    (``BatchedSearcher``); "auto" (the default) picks packed mode when the
    device is a GPU, as the reference does on any accelerator.  A path
    holding a ``federation.json`` opens as a ``FederatedIndex``
    (core/federation.py), file mode only.
  * ``MultiIndexSession`` — N indexes under ONE shared byte-budget
    ``NodeCache``: a global LRU across indexes, runtime-resizable (the
    paper's §4.2 knob made fleet-wide).
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

import numpy as np

from .. import tracing
from ..device import resolve_device
from .store import IOStats

__all__ = [
    "SearchStats",
    "IOStats",
    "NodeCache",
    "ResultSet",
    "Query",
    "RestartQuery",
    "QueryClosedError",
    "StaleQueryError",
    "Searcher",
    "MutableIndex",
    "open_index",
    "MultiIndexSession",
    "pack_rows",
]

_UNSET = object()


class QueryClosedError(RuntimeError):
    """Raised when ``next``/``save`` is called on a closed Query handle."""


class StaleQueryError(RuntimeError):
    """Raised when a Query handle outlives a structural rewrite of its
    index (``compact()`` renumbers nodes, so a saved frontier no longer
    means anything).  Inserts and deletes do NOT stale a handle — they
    are append/tombstone-only."""


@dataclass
class SearchStats:
    node_loads: int = 0            # disk reads (cache misses served from the store);
                                   # in batch mode a row counts the misses IT demanded
                                   # (solo-equivalent) — actual deduped loads live in
                                   # the handle's batch_stats
    nodes_opened: int = 0          # total nodes popped from T
    leaves_opened: int = 0
    distance_calcs: int = 0        # individual distance computations
    increments: int = 0            # b-doublings
    rounds: int = 0                # lockstep batch rounds participated in (batch mode)
    dedup_hits: int = 0            # node demands served by a load another query in the
                                   # same round triggered (cross-query fetch dedup)
    kernel_launches: int = 0       # grouped device top-k launches (quantized scan);
                                   # exactly one per traversal round that scanned leaves
    io: IOStats = field(default_factory=IOStats)  # bytes/files/reads at the store;
                                   # zero per-row in batch mode (coalesced reads have
                                   # no per-row attribution; see batch_stats.io)


# --------------------------------------------------------------------- cache
class NodeCache:
    """LRU cache over node payloads ``key -> (embeddings f32, ids)``.

    Two independent budgets, both tunable at runtime (paper §4.2):
      ``max_nodes``:  None = unbounded; 0 = caching off; n > 0 = at most n
                      resident nodes.
      ``max_bytes``:  None = unbounded; 0 = caching off; n > 0 = resident
                      node data (embeddings + ids) capped at n bytes — the
                      fleet-wide knob ``MultiIndexSession`` shares across
                      indexes.

    Keys are opaque tuples whose FIRST element is a namespace tag, so
    several indexes can share one cache without collisions; eviction is
    globally LRU across all of them.  ``ECPIndex`` keys entries as
    ``(namespace, epoch, node_version, level, node)`` — the snapshot-aware
    schema of the serving subsystem: an in-place node rewrite bumps the
    node's version and a compaction bumps the epoch, so a pinned
    ``ECPSnapshot`` (which froze the old epoch/version map) and the live
    index can share this cache while never resolving each other's bytes.

    Values are either a ``(embeddings, ids)`` node payload, a bare array
    (leaf-ids side entries of the quantized scan), or any object with an
    ``nbytes`` attribute (``QuantNode`` companion blocks).

    ``pin(key, value)`` inserts an entry EXEMPT from LRU eviction, under
    its own ``pinned_max_bytes`` budget slice (separate from
    ``max_bytes``): ``ECPIndex(pin_internal=True)`` parks the internal
    tree levels there so leaf churn can never evict the navigation
    structure.  Pinned entries still honor ``invalidate`` /
    ``invalidate_namespace`` / ``clear``, so mutations behave as before.
    """

    @staticmethod
    def _norm_budget(v):
        """None = unbounded; any budget <= 0 means caching off."""
        if v is None:
            return None
        return max(0, int(v))

    def __init__(
        self,
        max_nodes: int | None = None,
        *,
        max_bytes: int | None = None,
        pinned_max_bytes: int | None = None,
    ):
        self.max_nodes = self._norm_budget(max_nodes)
        self.max_bytes = self._norm_budget(max_bytes)
        self.pinned_max_bytes = self._norm_budget(pinned_max_bytes)
        self._d: OrderedDict[tuple, tuple[np.ndarray, np.ndarray]] = OrderedDict()
        self._nbytes = 0
        self._pinned: dict = {}
        self._pinned_nbytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def _entry_bytes(value) -> int:
        nb = getattr(value, "nbytes", None)
        if nb is not None:
            return int(nb)
        return int(sum(a.nbytes for a in value))

    def resize(self, max_nodes=_UNSET, *, max_bytes=_UNSET) -> None:
        """Change either budget live; evicts immediately if shrinking."""
        with self._lock:
            if max_nodes is not _UNSET:
                self.max_nodes = self._norm_budget(max_nodes)
            if max_bytes is not _UNSET:
                self.max_bytes = self._norm_budget(max_bytes)
            self._evict_locked()

    def _evict_locked(self) -> None:
        def over() -> bool:
            if self.max_nodes is not None and len(self._d) > self.max_nodes:
                return True
            if self.max_bytes is not None and self._nbytes > self.max_bytes:
                return True
            return False

        while self._d and over():
            _, v = self._d.popitem(last=False)
            self._nbytes -= self._entry_bytes(v)
            self.evictions += 1

    def contains(self, key) -> bool:
        """Membership probe that does NOT touch LRU order or hit/miss stats
        (used by prefetch heuristics to skip already-resident nodes)."""
        with self._lock:
            return key in self._d or key in self._pinned

    def invalidate(self, key) -> bool:
        """Drop one entry (a node that was rewritten on disk); returns
        whether it was resident."""
        with self._lock:
            v = self._pinned.pop(key, None)
            if v is not None:
                self._pinned_nbytes -= self._entry_bytes(v)
                return True
            v = self._d.pop(key, None)
            if v is None:
                return False
            self._nbytes -= self._entry_bytes(v)
            return True

    def invalidate_namespace(self, ns) -> int:
        """Drop every entry of one index's namespace (compaction rewrote
        its whole tree); returns the number of entries dropped."""
        with self._lock:
            stale = [k for k in self._d if k[0] == ns]
            for k in stale:
                self._nbytes -= self._entry_bytes(self._d.pop(k))
            pstale = [k for k in self._pinned if k[0] == ns]
            for k in pstale:
                self._pinned_nbytes -= self._entry_bytes(self._pinned.pop(k))
            return len(stale) + len(pstale)

    def get(self, key):
        with self._lock:
            v = self._pinned.get(key)
            if v is not None:
                self.hits += 1
                return v
            v = self._d.get(key)
            if v is not None:
                self._d.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return v

    def pin(self, key, value) -> bool:
        """Insert an entry exempt from LRU eviction, accounted against the
        dedicated ``pinned_max_bytes`` slice (None = unbounded).  Returns
        False — after falling back to a normal ``put`` — when the slice is
        full, so callers degrade gracefully instead of overcommitting."""
        nb = self._entry_bytes(value)
        with self._lock:
            old = self._pinned.pop(key, None)
            if old is not None:
                self._pinned_nbytes -= self._entry_bytes(old)
            if (
                self.pinned_max_bytes is None
                or self._pinned_nbytes + nb <= self.pinned_max_bytes
            ):
                lru = self._d.pop(key, None)
                if lru is not None:
                    self._nbytes -= self._entry_bytes(lru)
                self._pinned[key] = value
                self._pinned_nbytes += nb
                return True
        self.put(key, value)
        return False

    def put(self, key, value) -> None:
        if self.max_nodes == 0 or self.max_bytes == 0:
            return
        with self._lock:
            if key in self._pinned:  # pinned copy is authoritative: refresh it
                self._pinned_nbytes -= self._entry_bytes(self._pinned[key])
                self._pinned[key] = value
                self._pinned_nbytes += self._entry_bytes(value)
                return
            old = self._d.pop(key, None)
            if old is not None:
                self._nbytes -= self._entry_bytes(old)
            self._d[key] = value
            self._nbytes += self._entry_bytes(value)
            self._evict_locked()

    @property
    def n_resident(self) -> int:
        return len(self._d) + len(self._pinned)

    @property
    def n_pinned(self) -> int:
        return len(self._pinned)

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._nbytes + self._pinned_nbytes

    @property
    def pinned_bytes(self) -> int:
        with self._lock:
            return self._pinned_nbytes

    def namespace_stats(self) -> dict:
        """Per-namespace (resident nodes, resident bytes) breakdown."""
        with self._lock:
            out: dict = {}
            for d in (self._pinned, self._d):
                for key, v in d.items():
                    ns = key[0]
                    n, b = out.get(ns, (0, 0))
                    out[ns] = (n + 1, b + self._entry_bytes(v))
            return out

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self._nbytes = 0
            self._pinned.clear()
            self._pinned_nbytes = 0


# ------------------------------------------------------------------ results
def pack_rows(
    dists_rows: list, ids_rows: list, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pad per-query result lists to rectangular [B, k] (+inf / -1 pads)."""
    B = len(dists_rows)
    d = np.full((B, k), np.inf, np.float32)
    i = np.full((B, k), -1, np.int64)
    for r, (dr, ir) in enumerate(zip(dists_rows, ids_rows)):
        n = min(len(ir), k)
        if n:
            d[r, :n] = np.asarray(dr[:n], np.float32)
            i[r, :n] = np.asarray(ir[:n], np.int64)
    return d, i


@dataclass
class ResultSet:
    """One emission of search results.

    ``dists``/``ids`` are ``[k]`` for a single-vector query and ``[B, k]``
    for a batch; rows with fewer than k hits are padded with ``+inf``/-1.
    ``stats`` is one ``SearchStats`` (single) or a list (batch); searchers
    without meaningful counters may leave it None.  ``query`` is the handle
    owning the incremental state — call ``.next(k)`` on it for more.
    """

    dists: np.ndarray
    ids: np.ndarray
    stats: SearchStats | list | None = None
    query: "Query | None" = None

    @property
    def batched(self) -> bool:
        return self.ids.ndim == 2

    def pairs(self) -> list[tuple[float, int]]:
        """Valid (dist, id) pairs of a single-query result, pads dropped."""
        if self.batched:
            raise ValueError("pairs() is for single-query results; index rows instead")
        return [(float(d), int(i)) for d, i in zip(self.dists, self.ids) if i >= 0]

    def row_ids(self, r: int) -> list[int]:
        if not self.batched and r != 0:
            raise IndexError(f"single-query ResultSet has only row 0, got {r}")
        ids = self.ids[r] if self.batched else self.ids
        return [int(i) for i in ids if i >= 0]

    def __len__(self) -> int:
        if self.batched:
            return int(self.ids.shape[0])
        return int((self.ids >= 0).sum())


# ------------------------------------------------------------------ queries
class Query:
    """Handle owning the incremental state of one ``search`` call."""

    _closed = False

    @property
    def closed(self) -> bool:
        return self._closed

    def _ensure_open(self) -> None:
        if self._closed:
            raise QueryClosedError(f"{type(self).__name__} is closed")

    def next(self, k: int) -> ResultSet:
        raise NotImplementedError

    def save(self, name: str | None = None) -> str:
        raise NotImplementedError(
            f"{type(self).__name__} has no persistent form; only file-structure "
            "(eCP-FS) queries support save()"
        )

    def close(self) -> None:
        self._closed = True


class RestartQuery(Query):
    """Continuation for searchers with no native incremental state.

    ``next(k)`` re-runs the underlying search asking for ``emitted + k``
    results and returns the tail — the paper's restart protocol for
    IVF / HNSW / DiskANN in the incremental workload (§5, Table 4).
    """

    def __init__(self, searcher: "Searcher", q: np.ndarray, k: int, *, b=None, opts: dict | None = None):
        self._searcher = searcher
        self._q = np.asarray(q)
        self._b = b
        self._opts = dict(opts or {})
        self._emitted = k

    def next(self, k: int) -> ResultSet:
        self._ensure_open()
        want = self._emitted + k
        rs = self._searcher.search(self._q, want, b=self._b, **self._opts)
        lo = self._emitted
        self._emitted = want
        if rs.batched:
            d, i = rs.dists[:, lo:want], rs.ids[:, lo:want]
        else:
            d, i = rs.dists[lo:want], rs.ids[lo:want]
        # re-pad to exactly k
        if i.shape[-1] < k:
            pad = k - i.shape[-1]
            pd = np.full(i.shape[:-1] + (pad,), np.inf, np.float32)
            pi = np.full(i.shape[:-1] + (pad,), -1, np.int64)
            d = np.concatenate([d, pd], axis=-1)
            i = np.concatenate([i, pi], axis=-1)
        return ResultSet(dists=d, ids=i, stats=rs.stats, query=self)


# ----------------------------------------------------------------- protocol
@runtime_checkable
class Searcher(Protocol):
    """Anything that answers k-NN queries through the unified shape."""

    def search(self, q, k: int = 100, *, b=None, **opts) -> ResultSet:
        ...



@runtime_checkable
class MutableIndex(Protocol):
    """A searcher whose index mutates while serving (core/lifecycle.py):
    ``insert`` appends + splits leaves, ``delete`` tombstones, ``compact``
    rewrites the tree to equal a fresh build of the live collection."""

    def search(self, q, k: int = 100, *, b=None, **opts) -> ResultSet:
        ...

    def insert(self, vectors, ids=None) -> dict:
        ...

    def delete(self, ids) -> int:
        ...

    def compact(self) -> dict:
        ...


# ------------------------------------------------------------------ factory
def open_index(
    path,
    mode: str = "auto",
    *,
    backend: str = "auto",
    prefetch: bool = False,
    cache: NodeCache | None = None,
    namespace: str | None = None,
    cache_max_nodes: int | None = None,
    cache_max_bytes: int | None = None,
    device="cuda",
    **kw,
) -> Searcher:
    """Open an eCP index as a ``Searcher``.

    mode="file"    -> ``ECPIndex``: lazy node loading, LRU cache, true
                      incremental search (the paper's mode).
    mode="packed"  -> ``BatchedSearcher``: whole hierarchy packed onto
                      ``device`` for level-synchronous batched search.
    mode="auto"    -> "packed" when ``device`` is a GPU, else "file"; a
                      file-mode-only option (cache budgets, ``namespace``,
                      ``prefetch``) also picks "file".

    ``backend`` picks the node storage (core/store.py): "fstore", "blob",
    or "auto" (blob when ``path`` is/contains a blob, else fstore).
    ``device`` is where the device work runs ("cuda" by default; "cpu"
    runs the plain PyTorch versions).  Extra keywords flow to the opened
    class (``quantized=``, ``probe_m=``, ``scorer=`` ...).

    So on a GPU, ``open_index(path)`` opens packed mode, as the reference
    does on any accelerator, and two things follow.  Its leaves differ from
    file mode's at the same ``b``: the level-synchronous beam ranks every
    leaf, where best-first opens the children of the nearest few level-1
    nodes, so the two return different top-k lists (``PERF.md`` gives the
    share they hold in common at the paper's widths).  And packed mode refuses an index holding
    tombstones (``load_packed`` raises ``ValueError`` until ``compact()``),
    so "auto" on a GPU raises on an index with deletes; ``mode="file"``
    searches it.

    A path holding a federation manifest (``federation.json``) opens as a
    ``FederatedIndex`` — one logical index scatter-gathering over its
    shards (core/federation.py).  It is file-mode only: "auto" keeps it a
    federation on a GPU too, and "packed" raises ``ValueError``.  Its
    shards run their device work on ``device``.
    """
    if mode not in ("file", "packed", "auto"):
        raise ValueError(f"unknown open_index mode: {mode!r} (file|packed|auto)")
    if isinstance(path, (str, os.PathLike)):
        from .federation import FederatedIndex, find_manifest

        if find_manifest(path) is not None:
            if mode not in ("auto", "file"):
                raise ValueError(
                    f"a federated index only supports mode='file', got {mode!r}"
                )
            return FederatedIndex(
                path,
                backend=backend,
                prefetch=prefetch,
                cache=cache,
                namespace=namespace,
                cache_max_nodes=cache_max_nodes,
                cache_max_bytes=cache_max_bytes,
                device=device,
                **kw,
            )
    wants_cache = (
        cache is not None
        or namespace is not None
        or cache_max_nodes is not None
        or cache_max_bytes is not None
    )
    wants_prefetch = prefetch or backend.endswith("+prefetch")
    if mode == "auto":
        if wants_cache or wants_prefetch:
            mode = "file"  # cache budgets / prefetch are file-mode requests
        else:
            mode = "packed" if resolve_device(device).type == "cuda" else "file"
    if mode == "file":
        from .search import ECPIndex

        return ECPIndex(
            path,
            backend=backend,
            prefetch=prefetch,
            cache=cache,
            namespace=namespace,
            cache_max_nodes=cache_max_nodes,
            cache_max_bytes=cache_max_bytes,
            device=device,
            **kw,
        )
    if wants_cache or wants_prefetch:
        raise ValueError(
            "packed mode loads the whole hierarchy onto the device; "
            "cache/namespace/cache_max_*/prefetch only apply to mode='file'"
        )
    from . import batched
    from .packed import load_packed
    from .store import open_store

    with tracing.phase("ecpfs.open.load"):  # read and padded on the host
        store = open_store(path, backend=backend)
        try:
            packed = load_packed(store)
        finally:
            store.close()
    with tracing.phase("ecpfs.open.upload"):  # onto the device, normalised
        return batched.BatchedSearcher(packed, device=device, **kw)


# ------------------------------------------------------------------ session
class MultiIndexSession:
    """N indexes under one shared byte-budget node cache (paper §1, §6.1).

    Every index opened through the session shares a single globally-LRU
    ``NodeCache`` budgeted in bytes; a node loaded for any index can evict
    the coldest node of any other.  The budget is runtime-resizable —
    the paper's "limit changeable at run-time" made fleet-wide.

        sess = MultiIndexSession(cache_bytes=8 << 20)
        lifelog = sess.open("/idx/lifelog")
        docs = sess.open("/idx/docs")
        rs = lifelog.search(q, k=10, b=8)
        sess.resize(cache_bytes=2 << 20)     # shrink the whole fleet live
    """

    def __init__(
        self,
        *,
        cache_bytes: int | None = None,
        cache_nodes: int | None = None,
    ):
        self.cache = NodeCache(cache_nodes, max_bytes=cache_bytes)
        self._indexes: dict[str, Searcher] = {}

    def open(self, path, name: str | None = None, *, mode: str = "file", **kw) -> Searcher:
        """Open an index under the shared cache and register it by name."""
        if name is None:
            name = str(path).rstrip("/").rsplit("/", 1)[-1]
        if name in self._indexes:
            raise ValueError(f"index name already open in session: {name!r}")
        if mode == "file":
            s = open_index(path, mode="file", cache=self.cache, namespace=name, **kw)
        else:
            # packed/auto indexes are device-resident; they do not draw from
            # the shared node budget but stay addressable via the session.
            s = open_index(path, mode=mode, **kw)
        self._indexes[name] = s
        return s

    def __getitem__(self, name: str) -> Searcher:
        return self._indexes[name]

    def __contains__(self, name: str) -> bool:
        return name in self._indexes

    def names(self) -> list[str]:
        return list(self._indexes)

    def search(self, name: str, q, k: int = 100, *, b=None, **opts) -> ResultSet:
        return self._indexes[name].search(q, k, b=b, **opts)

    def resize(self, *, cache_bytes=_UNSET, cache_nodes=_UNSET) -> None:
        self.cache.resize(cache_nodes, max_bytes=cache_bytes)

    def stats(self) -> dict:
        raw = self.cache.namespace_stats()
        # a federated index registers its shards under "<name>/<shard>"
        # namespaces: roll those up so per_index charges each index for
        # everything it holds
        per: dict = {}
        for ns, (n, b) in raw.items():
            base = ns.split("/", 1)[0]
            pn, pb = per.get(base, (0, 0))
            per[base] = (pn + n, pb + b)
        return {
            "indexes": self.names(),
            "resident_nodes": self.cache.n_resident,
            "resident_bytes": self.cache.resident_bytes,
            "budget_bytes": self.cache.max_bytes,
            "hits": self.cache.hits,
            "misses": self.cache.misses,
            "evictions": self.cache.evictions,
            "per_index": {
                n: {"nodes": per.get(n, (0, 0))[0], "bytes": per.get(n, (0, 0))[1]}
                for n in self._indexes
            },
        }

    def invalidate(self, name: str) -> int:
        """Resynchronize one index whose files changed on disk outside
        this process: refresh its in-memory metadata/root/tombstones when
        the searcher supports it (``ECPIndex.refresh``), and drop its
        cached nodes.  Indexes opened through the session invalidate
        themselves on their own writes — this is for external writers."""
        s = self._indexes.get(name)
        refresh = getattr(s, "refresh", None)
        if refresh is not None:
            refresh()  # includes invalidate_namespace(name)
            return 0
        return self.cache.invalidate_namespace(name)

    def close(self) -> None:
        """Close every index opened through the session (freeing prefetch
        executors and store fds) and drop the shared cache."""
        for s in self._indexes.values():
            close = getattr(s, "close", None)
            if close is not None:
                close()
        self._indexes.clear()
        self.cache.clear()

    def __enter__(self) -> "MultiIndexSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
