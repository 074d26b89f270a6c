"""Tiered shard federation — one logical eCP index over many blob files
(the port's counterpart of the reference's ``core/federation.py``).

The paper's file structure has a hard ceiling: one index, one file.  This
module composes N per-shard ``ECPIndex`` files into a single logical
``Searcher``/``MutableIndex`` behind a small in-memory *master router*
built from each shard's top-level leader centroids (the root node every
shard already reads at open, §4.2) — the FusionANNS recipe of a cheap
top-level structure routing over disk-resident partitions with a per-
partition effort budget.

  * ``FederationManifest`` — a human-readable JSON file
    (``federation.json``) in the federation root, keeping the paper's
    file-structure idiom: shard names/paths/backends, per-shard
    generations and item counts, and the router centroids, so external
    tools can route (or audit) without opening a single shard.
  * ``FederatedIndex`` — scatter-gather search: the router scores each
    shard by its nearest leader centroid, ``allocate_effort`` splits the
    effort knob ``b`` across the top-m shards proportionally to router
    affinity (total conserved exactly, floor ``b_min`` per probed
    shard), per-shard ``ResultSet`` streams merge through one global
    top-k heap, and ``SearchStats``/``IOStats`` aggregate per shard and
    in total.  Inserts route to the nearest shard leader (spilling to
    the emptiest shard past a balance threshold), deletes fan out,
    ``compact`` runs shard-by-shard (``compact_async`` through the
    serving scheduler, so snapshot readers re-pin between shards and
    never block).
  * ``FederatedSnapshot`` — generation-pinned read-only view composed of
    per-shard ``ECPSnapshot``\\ s; the serving scheduler leases it like a
    single-file snapshot.
  * ``build_federation`` — split one collection into N shards, build +
    convert each, write the manifest.

Shards share one ``NodeCache`` (namespaced ``<fed>/<shard>``), so a
federation opened through ``MultiIndexSession`` draws from the session's
shared byte budget like any other index.  ``open_index`` auto-detects
``federation.json``.

The router, the effort split, the merge and every file written are host
numpy copied from the reference, so the manifest and the shard files are
the reference's byte for byte and either package opens the other's
federation.  The device work is the shards': ``FederatedIndex`` and
``build_federation`` take ``device`` ("cuda" by default) and hand it to
every shard's ``ECPIndex`` and to ``build_index``, so a shard opened
``quantized=True`` scores each traversal round's leaves in one
``grouped_distance_topk`` launch, and one opened with
``scorer=make_kernel_scorer()`` scores its leaves through ``distance_topk``.
"""
from __future__ import annotations

import json
import os
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..device import resolve_device
from .api import NodeCache, Query, ResultSet, SearchStats, pack_rows
from .distances import np_distances
from .store import BLOB_FILENAME

MANIFEST_FILENAME = "federation.json"
MANIFEST_FORMAT = "ecp-federation/1"

__all__ = [
    "MANIFEST_FILENAME",
    "FederationManifest",
    "FederationInfo",
    "FederatedIndex",
    "FederatedSnapshot",
    "FederatedQuery",
    "allocate_effort",
    "build_federation",
    "find_manifest",
    "discover_shards",
]


# ----------------------------------------------------------------- manifest
def find_manifest(path) -> Path | None:
    """The federation manifest at/under ``path``, or None.  Accepts the
    manifest file itself or a directory containing one."""
    p = Path(path)
    if p.is_file() and p.name == MANIFEST_FILENAME:
        return p
    if p.is_dir() and (p / MANIFEST_FILENAME).is_file():
        return p / MANIFEST_FILENAME
    return None


def discover_shards(root) -> list[dict]:
    """Shard-looking entries directly under ``root``: blob files, blob
    directories, and fstore index roots.  Used by ``adopt_shard`` and the
    ``open_store`` auto-detection diagnostics."""
    out = []
    p = Path(root)
    if not p.is_dir():
        return out
    for child in sorted(p.iterdir()):
        if child.name == MANIFEST_FILENAME:
            continue
        if child.is_file() and child.suffix == ".blob":
            out.append({"name": child.stem, "path": child.name, "backend": "blob"})
        elif child.is_dir() and (child / BLOB_FILENAME).is_file():
            out.append({"name": child.name, "path": child.name, "backend": "blob"})
        elif child.is_dir() and (child / ".zgroup").is_file():
            out.append({"name": child.name, "path": child.name, "backend": "fstore"})
    return out


@dataclass
class FederationManifest:
    """The on-disk description of a federation (``federation.json``).

    ``shards`` entries are plain dicts — ``name``, ``path`` (relative to
    the manifest's directory), ``backend`` (``blob``/``fstore``),
    ``generation``, ``n_items``, and ``router`` (that shard's top-level
    leader centroids as nested lists) — so the file stays greppable and
    hand-editable, like every other file in the structure.
    """

    metric: str
    dim: int
    dtype: str = "float16"
    shards: list[dict] = field(default_factory=list)
    format: str = MANIFEST_FORMAT

    def to_json(self) -> dict:
        return {
            "format": self.format,
            "metric": self.metric,
            "dim": int(self.dim),
            "dtype": self.dtype,
            "shards": self.shards,
        }

    @staticmethod
    def from_json(d: dict) -> "FederationManifest":
        fmt = str(d.get("format", ""))
        if not fmt.startswith("ecp-federation/"):
            raise ValueError(f"not a federation manifest (format={fmt!r})")
        return FederationManifest(
            metric=d["metric"],
            dim=int(d["dim"]),
            dtype=d.get("dtype", "float16"),
            shards=list(d.get("shards", [])),
            format=fmt,
        )

    def save(self, root) -> Path:
        """Atomically (tmp + rename) write ``root/federation.json``."""
        root = Path(root)
        dst = root / MANIFEST_FILENAME if root.is_dir() or not root.suffix else root
        tmp = dst.with_name(dst.name + ".tmp")
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=2)
            f.write("\n")
        os.replace(tmp, dst)
        return dst

    @staticmethod
    def load(path) -> "FederationManifest":
        mp = find_manifest(path)
        if mp is None:
            raise FileNotFoundError(f"no {MANIFEST_FILENAME} at {path}")
        with open(mp) as f:
            return FederationManifest.from_json(json.load(f))


@dataclass
class FederationInfo:
    """The ``info`` shim the serving layer reads off any index: totals
    over the live shards (generation = sum of shard generations, so every
    shard mutation moves it monotonically; next_id = max, so federation-
    allocated ids never collide with any shard's)."""

    dim: int
    metric: str
    dtype: str
    n_items: int
    n_shards: int
    generation: int
    next_id: int
    version: str = MANIFEST_FORMAT


# ------------------------------------------------------------ effort split
def allocate_effort(
    d: np.ndarray,
    owner: np.ndarray,
    b: int,
    *,
    n_shards: int | None = None,
    b_min: int = 1,
    top_m: int | None = None,
    probe_m: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """Split total effort ``b`` across shards by a global leader vote.

    ``d[j]``: the query's distance to router centroid ``j``; ``owner[j]``:
    which shard that centroid belongs to.  The ``b`` globally-nearest
    centroids each cast one vote for their shard — so a random split
    (every shard statistically identical) degrades to a near-uniform
    split, while a semantic split (one shard owns the query's region)
    concentrates effort there.  Effort goes to the ``top_m`` most-voted
    shards, proportionally to votes, floored at ``b_min``, and rounding
    is repaired so ``alloc.sum() == b`` EXACTLY — federating conserves
    total effort, never amplifies it.

    Budget-floor rule (the documented clamp): a probed shard must be
    fundable at its effective floor ``b_min_eff = max(1, b_min) *
    max(1, probe_m)`` — multi-probe traversal (``probe_m > 1``) widens
    each shard's per-increment leaf appetite, so the floor scales with
    it.  When ``b < m * b_min_eff`` the probe count is CLAMPED to
    ``max(1, b // b_min_eff)`` rather than thinning allocations below
    the floor; with ``b_min=0`` there is no caller floor (the effective
    floor is 1: a probed shard always gets at least one leaf).  Negative
    ``b_min`` raises ``ValueError``.

    Returns ``(probe, alloc)``: probed shard indices (most-voted first)
    and their integer ``b`` shares.
    """
    d = np.asarray(d, np.float64).reshape(-1)
    owner = np.asarray(owner, np.int64).reshape(-1)
    if len(d) == 0 or len(d) != len(owner):
        raise ValueError("allocate_effort: empty or mismatched router arrays")
    if int(b_min) < 0:
        raise ValueError(f"b_min must be >= 0, got {b_min}")
    S = int(owner.max()) + 1 if n_shards is None else int(n_shards)
    b = max(1, int(b))
    b_min_eff = max(1, int(b_min)) * max(1, int(probe_m))
    ranked = np.argsort(d, kind="stable")[: max(1, b)]
    votes = np.zeros(S, np.float64)
    np.add.at(votes, owner[ranked], 1.0)
    shard_min = np.full(S, np.inf)
    np.minimum.at(shard_min, owner, d)
    # most-voted first; ties break by nearest centroid, then shard index
    cand = sorted(
        (i for i in range(S) if np.isfinite(shard_min[i])),
        key=lambda i: (-votes[i], shard_min[i], i),
    )
    cand = [i for i in cand if votes[i] > 0] or cand[:1]
    m = len(cand) if top_m is None else max(1, min(int(top_m), len(cand)))
    m = min(m, max(1, b // b_min_eff))  # the documented clamp: never fund
    # more shards than b can cover at b_min_eff each
    probe = np.asarray(cand[:m], np.int64)
    if m == 1:
        return probe, np.array([b], np.int64)
    w = votes[probe]
    if w.sum() <= 0:
        w = np.ones(m)
    alloc = np.maximum(b_min_eff, np.floor(b * w / w.sum())).astype(np.int64)
    diff = b - int(alloc.sum())
    i = 0
    while diff > 0:  # hand out the remainder most-voted-first
        alloc[i % m] += 1
        diff -= 1
        i += 1
    while diff < 0:  # claw back overshoot least-voted-first, floor intact
        j = m - 1 - (i % m)
        if alloc[j] > b_min_eff:
            alloc[j] -= 1
            diff += 1
        i += 1
    return probe, alloc


def _sum_stats(per: list[SearchStats]) -> SearchStats:
    """Every counter of the shards' ``SearchStats`` summed, the grouped
    kernel's launches included (the reference's sum leaves them at 0)."""
    tot = SearchStats()
    for s in per:
        if s is None:
            continue
        tot.node_loads += s.node_loads
        tot.nodes_opened += s.nodes_opened
        tot.leaves_opened += s.leaves_opened
        tot.distance_calcs += s.distance_calcs
        tot.increments += s.increments
        tot.rounds += s.rounds
        tot.dedup_hits += s.dedup_hits
        tot.kernel_launches += s.kernel_launches
        tot.io.add(s.io)
    return tot


# ------------------------------------------------------------- query merge
class _ShardStream:
    """One probed shard's emission stream: the sorted pairs of its latest
    emission buffer, refilled from the underlying ``ECPQuery`` on demand."""

    __slots__ = ("name", "query", "buf", "pos", "exhausted")

    def __init__(self, name: str, rs: ResultSet):
        self.name = name
        self.query = rs.query
        self.buf: list[tuple[float, int]] = rs.pairs()
        self.pos = 0
        self.exhausted = not self.buf and rs.query is None

    def head(self) -> tuple[float, int] | None:
        return self.buf[self.pos] if self.pos < len(self.buf) else None

    def pop(self) -> tuple[float, int]:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def refill(self, k: int) -> None:
        """Ask the shard for its next emission (one more ``next(k)``)."""
        if self.exhausted or self.query is None or self.query.closed:
            self.exhausted = True
            return
        pairs = self.query.next(k).pairs()
        if pairs:
            self.buf = pairs
            self.pos = 0
        else:
            self.exhausted = True


class _RowState:
    """Per-query-row scatter state: probed shards, their allocations, and
    the merge streams."""

    __slots__ = ("streams", "allocation")

    def __init__(self, streams: list[_ShardStream], allocation: dict):
        self.streams = streams
        self.allocation = allocation

    def merge(self, k: int, *, refill: bool) -> tuple[list, list]:
        """Pop the next k globally-smallest pairs across the streams.
        With ``refill`` (continuations), an empty stream pulls its next
        emission; the initial emission merges only what the allotted
        per-shard ``b`` already bought."""
        if refill:
            for st in self.streams:
                if st.head() is None:
                    st.refill(k)
        dists: list[float] = []
        ids: list[int] = []
        while len(ids) < k:
            best = None
            for st in self.streams:
                h = st.head()
                if h is not None and (best is None or h < best.head()):
                    best = st
            if best is None:
                break
            d, i = best.pop()
            dists.append(d)
            ids.append(i)
            if refill and best.head() is None:
                best.refill(k)
        return dists, ids

    def stats(self) -> dict[str, SearchStats]:
        out = {}
        for st in self.streams:
            if st.query is not None:
                out[st.name] = st.query.stats
        return out

    def close(self) -> None:
        for st in self.streams:
            if st.query is not None and not st.query.closed:
                st.query.close()


class FederatedQuery(Query):
    """The incremental handle of a federated search: a k-way merge over
    the probed shards' own ``ECPQuery`` streams.  ``next(k)`` lets each
    underfull stream advance (the shards' Algorithm 2 continuations) and
    re-merges; per-shard effort stays observable via ``allocation`` and
    ``shard_stats``."""

    def __init__(self, rows: list[_RowState], *, single: bool):
        self._rows = rows
        self._single = single

    @property
    def allocation(self) -> dict | list[dict]:
        """Per-shard effort (``b``) granted to this query; a dict for a
        single-row query, a list of dicts for a batch."""
        if self._single:
            return dict(self._rows[0].allocation)
        return [dict(r.allocation) for r in self._rows]

    @property
    def shard_stats(self) -> dict | list[dict]:
        """Cumulative per-shard ``SearchStats`` (single: dict; batch:
        list of dicts)."""
        if self._single:
            return self._rows[0].stats()
        return [r.stats() for r in self._rows]

    @property
    def stats(self):
        """Aggregated total(s) across the probed shards."""
        if self._single:
            return _sum_stats(list(self._rows[0].stats().values()))
        return [_sum_stats(list(r.stats().values())) for r in self._rows]

    def next(self, k: int) -> ResultSet:
        self._ensure_open()
        rows = [r.merge(k, refill=True) for r in self._rows]
        d, i = pack_rows([r[0] for r in rows], [r[1] for r in rows], k)
        if self._single:
            return ResultSet(dists=d[0], ids=i[0], stats=self.stats, query=self)
        return ResultSet(dists=d, ids=i, stats=self.stats, query=self)

    def close(self) -> None:
        if not self._closed:
            for r in self._rows:
                r.close()
        super().close()


# -------------------------------------------------------- scatter-gather
class _ScatterGather:
    """Search core shared by ``FederatedIndex`` and ``FederatedSnapshot``.

    Hosts provide ``_shard_names`` / ``_shard_objs`` (parallel lists),
    ``_router_emb`` (stacked leader centroids), ``_router_owner`` (which
    shard each centroid belongs to), ``_router_slices`` (one ``(lo, hi)``
    per shard into the stack), ``metric``, ``b_min``, ``top_m`` and
    ``probe_m``."""

    _shard_names: list
    _shard_objs: list
    _router_emb: np.ndarray
    _router_owner: np.ndarray
    _router_slices: list
    metric: str
    b_min: int
    top_m: int | None
    probe_m: int = 1

    def shard_affinity(self, q: np.ndarray) -> np.ndarray:
        """Router score per shard: distance to its nearest top-level
        leader centroid.  ``q`` [D] -> [S] (or [B, D] -> [B, S])."""
        d = np_distances(q, self._router_emb, self.metric)
        lo_hi = self._router_slices
        if d.ndim == 1:
            return np.array([d[lo:hi].min() for lo, hi in lo_hi], np.float32)
        return np.stack([d[:, lo:hi].min(axis=1) for lo, hi in lo_hi], axis=1)

    def _search_row(
        self, q: np.ndarray, k: int, b: int, mx_inc: int, exclude, probe_m: int
    ) -> _RowState:
        probe, alloc = allocate_effort(
            np_distances(q, self._router_emb, self.metric),
            self._router_owner,
            b,
            n_shards=len(self._shard_objs),
            b_min=self.b_min,
            top_m=self.top_m,
            probe_m=probe_m,  # probing widens per-shard effort demand
        )
        streams, allocation = [], {}
        for si, bi in zip(probe, alloc):
            name = self._shard_names[int(si)]
            rs = self._shard_objs[int(si)].search(
                q, k, b=int(bi), mx_inc=mx_inc, exclude=exclude, probe_m=probe_m
            )
            allocation[name] = int(bi)
            streams.append(_ShardStream(name, rs))
        return _RowState(streams, allocation)

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
        """Scatter-gather search over one vector [D] or a batch [B, D]:
        route, split ``b``, search each probed shard, merge the emissions
        through one global top-k (shard id spaces are disjoint, so the
        merge never deduplicates).  ``probe_m`` (default: the federation's
        configured value) is forwarded to every probed shard's traversal
        and widens the allocator's per-shard funding floor."""
        if not self._shard_objs:
            raise ValueError("federation has no shards")
        b = 8 if b is None else int(b)
        pm = self.probe_m if probe_m is None else max(1, int(probe_m))
        q = np.asarray(q, np.float32)
        single = q.ndim == 1
        Q = q[None, :] if single else q
        states = [self._search_row(row, k, b, mx_inc, exclude, pm) for row in Q]
        rows = [st.merge(k, refill=False) for st in states]
        d, i = pack_rows([r[0] for r in rows], [r[1] for r in rows], k)
        query = FederatedQuery(states, single=single)
        if single:
            return ResultSet(dists=d[0], ids=i[0], stats=query.stats, query=query)
        return ResultSet(dists=d, ids=i, stats=query.stats, query=query)


# ------------------------------------------------------------------- index
class FederatedIndex(_ScatterGather):
    """One logical eCP index over N shard files (a ``Searcher`` and a
    ``MutableIndex``).  See the module docstring for the architecture;
    every mutation rewrites the manifest (tmp + rename) so the on-disk
    description always names the published per-shard generations."""

    def __init__(
        self,
        path,
        *,
        backend: str = "auto",
        prefetch: bool = False,
        cache: NodeCache | None = None,
        namespace: str | None = None,
        cache_max_nodes: int | None = None,
        cache_max_bytes: int | None = None,
        b_min: int = 1,
        top_m: int | None = None,
        probe_m: int = 1,
        balance_factor: float = 2.0,
        device="cuda",
        **shard_kw,
    ):
        self.device = resolve_device(device)
        mp = find_manifest(path)
        if mp is None:
            raise FileNotFoundError(f"no {MANIFEST_FILENAME} at {path}")
        self.root = mp.parent
        self.manifest = FederationManifest.load(mp)
        self.cache = (
            cache
            if cache is not None
            else NodeCache(cache_max_nodes, max_bytes=cache_max_bytes)
        )
        self._ns = namespace if namespace is not None else str(self.root)
        self._mut_lock = threading.RLock()
        self.b_min = max(1, int(b_min))
        self.top_m = top_m
        self.probe_m = max(1, int(probe_m))
        self.balance_factor = float(balance_factor)
        self._default_backend = backend
        self._shard_kw = dict(prefetch=prefetch, device=self.device, **shard_kw)
        self._shards: dict[str, object] = {}
        for entry in self.manifest.shards:
            self._open_shard(entry)
        if not self._shards:
            raise ValueError(f"federation manifest lists no shards: {mp}")
        self._rebuild_router()

    # ------------------------------------------------------------ plumbing
    def _open_shard(self, entry: dict):
        from .search import ECPIndex

        name = entry["name"]
        if name in self._shards:
            raise ValueError(f"duplicate shard name in manifest: {name!r}")
        idx = ECPIndex(
            str(self.root / entry["path"]),
            backend=entry.get("backend", self._default_backend),
            cache=self.cache,
            namespace=f"{self._ns}/{name}",
            **self._shard_kw,
        )
        if self._shards:
            first = next(iter(self._shards.values()))
            if idx.info.dim != first.info.dim or idx.info.metric != first.info.metric:
                idx.close()
                raise ValueError(
                    f"shard {name!r} is dim={idx.info.dim}/{idx.info.metric}, "
                    f"federation is dim={first.info.dim}/{first.info.metric}"
                )
        self._shards[name] = idx
        return idx

    def _rebuild_router(self) -> None:
        """Stack the shards' top-level leader centroids (each shard's root
        node, already memory-resident) into the router arrays."""
        names, objs, slices, blocks = [], [], [], []
        at = 0
        for name, idx in self._shards.items():
            emb = np.asarray(idx.root_emb, np.float32)
            names.append(name)
            objs.append(idx)
            slices.append((at, at + len(emb)))
            blocks.append(emb)
            at += len(emb)
        self._shard_names = names
        self._shard_objs = objs
        self._router_slices = slices
        self._router_emb = (
            np.concatenate(blocks, axis=0)
            if blocks
            else np.empty((0, self.manifest.dim), np.float32)
        )
        self._router_owner = np.concatenate(
            [np.full(hi - lo, i, np.int64) for i, (lo, hi) in enumerate(slices)]
        ) if slices else np.empty(0, np.int64)

    def _save_manifest(self) -> None:
        """Re-derive the manifest from the live shards and rewrite it."""
        entries = []
        for name, idx in self._shards.items():
            spath = Path(idx._reopen["path"]) if idx._reopen else Path(name)
            try:
                rel = spath.relative_to(self.root)
            except ValueError:
                rel = Path(os.path.relpath(spath, self.root))
            entries.append(
                {
                    "name": name,
                    "path": str(rel),
                    "backend": idx.store.backend.split("+")[0],
                    "generation": int(idx.info.generation),
                    "n_items": int(idx.info.n_items),
                    "router": [
                        [round(float(x), 6) for x in row]
                        for row in np.asarray(idx.root_emb, np.float32)
                    ],
                }
            )
        self.manifest.shards = entries
        self.manifest.save(self.root)

    # ------------------------------------------------------------- surface
    @property
    def metric(self) -> str:
        return self.manifest.metric

    @property
    def shard_names(self) -> list[str]:
        return list(self._shards)

    def shard(self, name: str):
        return self._shards[name]

    @property
    def info(self) -> FederationInfo:
        shards = list(self._shards.values())
        return FederationInfo(
            dim=shards[0].info.dim if shards else self.manifest.dim,
            metric=self.manifest.metric,
            dtype=self.manifest.dtype,
            n_items=sum(s.info.n_items for s in shards),
            n_shards=len(shards),
            generation=sum(s.info.generation for s in shards),
            next_id=max((s.info.next_id for s in shards), default=0),
        )

    @property
    def generation(self) -> int:
        return self.info.generation

    @property
    def tombstones(self) -> set:
        out: set = set()
        for s in self._shards.values():
            out |= s.tombstones
        return out

    @property
    def supports_snapshot(self) -> bool:
        """True when every shard's store pins generations (blob)."""
        return bool(self._shards) and all(
            getattr(s.store, "pin", None) is not None for s in self._shards.values()
        )

    # ----------------------------------------------------------- mutation
    def insert(self, vectors, ids=None) -> dict:
        """Route each vector to the shard whose leader is nearest; a shard
        already holding more than ``balance_factor`` times the mean load
        spills to the emptiest shard instead.  Ids default from the
        federation-wide allocator (max of the shards' ``next_id``), so
        they stay unique across every shard."""
        with self._mut_lock:
            Q = np.asarray(vectors, np.float32)
            if Q.ndim == 1:
                Q = Q[None, :]
            n = len(Q)
            dim = self.info.dim
            if Q.ndim != 2 or (n and Q.shape[1] != dim):
                raise ValueError(f"vectors must be [n, {dim}], got {list(Q.shape)}")
            if ids is None:
                base = self.info.next_id
                ids = np.arange(base, base + n, dtype=np.int64)
            else:
                ids = np.asarray(ids, np.int64)
                if ids.shape != (n,):
                    raise ValueError(f"ids must be [n]={n}, got {list(ids.shape)}")
            if n == 0:
                return {
                    "inserted": 0,
                    "splits": 0,
                    "leaves": 0,
                    "generation": self.info.generation,
                    "per_shard": {},
                }
            names = self._shard_names
            counts = {nm: self._shards[nm].info.n_items for nm in names}
            total = sum(counts.values()) + n
            threshold = self.balance_factor * max(1.0, total / len(names))
            nearest = np.argmin(self.shard_affinity(Q), axis=1)
            target: dict[str, list[int]] = {}
            for r in range(n):
                nm = names[int(nearest[r])]
                if counts[nm] + 1 > threshold:  # overloaded: spill
                    nm = min(counts, key=lambda x: (counts[x], names.index(x)))
                counts[nm] += 1
                target.setdefault(nm, []).append(r)
            out = {"inserted": n, "splits": 0, "leaves": 0, "per_shard": {}}
            for nm, rows in target.items():
                r = self._shards[nm].insert(Q[rows], ids[rows])
                out["splits"] += r["splits"]
                out["leaves"] += r["leaves"]
                out["per_shard"][nm] = len(rows)
            self._rebuild_router()  # splits can rewrite a shard's root
            self._save_manifest()
            out["generation"] = self.info.generation
            return out

    def delete(self, ids) -> int:
        """Fan the tombstones out to every shard (ids are not located
        first — a tombstone for an absent id is a harmless no-op, and
        per-shard ``compact`` clears them).  Returns the number of ids
        newly tombstoned federation-wide."""
        with self._mut_lock:
            added = max(s.delete(ids) for s in self._shards.values())
            self._save_manifest()
            return added

    def compact(self) -> dict:
        """Compact every shard in turn (each a deterministic rebuild of
        its live items).  Snapshot readers keep their pinned generations
        throughout; use ``compact_async`` to run this off-thread through
        the serving scheduler."""
        out = {}
        for name in list(self._shards):
            out[name] = self.compact_shard(name)
        return {"shards": out, "generation": self.info.generation}

    def compact_shard(self, name: str) -> dict:
        """Compact one shard and republish the manifest — the unit of
        background compaction (scheduler ``mutate`` granularity)."""
        with self._mut_lock:
            out = self._shards[name].compact()
            self._rebuild_router()
            self._save_manifest()
            return out

    def compact_async(self, scheduler=None) -> Future:
        """Background per-shard compaction.  With a ``RequestScheduler``,
        each shard goes through ``scheduler.mutate`` so readers re-pin to
        the fresh generation after every shard and never block mid-sweep;
        without one the shards compact directly.  Returns a ``Future``
        resolving to the per-shard result dict."""
        fut: Future = Future()

        def run() -> None:
            try:
                out = {}
                for name in list(self._shards):
                    step = lambda nm=name: self.compact_shard(nm)  # noqa: E731
                    out[name] = scheduler.mutate(step) if scheduler else step()
                fut.set_result({"shards": out, "generation": self.info.generation})
            except BaseException as e:  # surfaced via fut.result()
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True, name="fed-compact").start()
        return fut

    # ---------------------------------------------------------- snapshots
    def snapshot(self) -> "FederatedSnapshot":
        """A generation-pinned read-only view: one ``ECPSnapshot`` per
        shard plus a frozen router, taken atomically under the mutation
        lock so the pinned per-shard generations are a published state."""
        if not self.supports_snapshot:
            raise NotImplementedError(
                "snapshot() needs every shard on a generation-pinning "
                "store (blob); serialize readers and writers externally "
                "instead (launch/scheduler.py does)"
            )
        with self._mut_lock:
            return FederatedSnapshot(self)

    # ------------------------------------------------------------ topology
    def adopt_shard(self, path, name: str | None = None) -> str:
        """Bring a shard discovered on disk into the federation live: open
        it, validate dim/metric, extend the router, republish the
        manifest."""
        with self._mut_lock:
            p = Path(path)
            if name is None:
                name = p.stem if p.is_file() else p.name
            entry = {"name": name, "path": str(p), "backend": self._default_backend}
            self._open_shard(entry)
            self._rebuild_router()
            self._save_manifest()
            return name

    def evict_shard(self, name: str):
        """Remove a shard from the federation (its files stay on disk);
        returns the closed shard's last ``IndexInfo``."""
        with self._mut_lock:
            if name not in self._shards:
                raise KeyError(f"no such shard: {name!r}")
            if len(self._shards) == 1:
                raise ValueError("cannot evict the last shard")
            idx = self._shards.pop(name)
            info = idx.info
            idx.close()
            self.cache.invalidate_namespace(f"{self._ns}/{name}")
            self._rebuild_router()
            self._save_manifest()
            return info

    def refresh(self) -> None:
        """Resynchronize with the files after an external writer changed
        them: re-read the manifest (adopting/evicting shards it gained or
        lost), refresh every remaining shard, rebuild the router."""
        with self._mut_lock:
            self.manifest = FederationManifest.load(self.root)
            listed = {e["name"]: e for e in self.manifest.shards}
            for name in [n for n in self._shards if n not in listed]:
                idx = self._shards.pop(name)
                idx.close()
                self.cache.invalidate_namespace(f"{self._ns}/{name}")
            for name, idx in self._shards.items():
                idx.refresh()
            for name, entry in listed.items():
                if name not in self._shards:
                    self._open_shard(entry)
            self._rebuild_router()

    def close(self) -> None:
        """Close every shard (store fds, prefetch executors).  Idempotent."""
        for idx in self._shards.values():
            idx.close()

    def __enter__(self) -> "FederatedIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class FederatedSnapshot(_ScatterGather):
    """Read-only scatter-gather over per-shard ``ECPSnapshot``\\ s, pinned
    at one published federation generation.  Refcounted like
    ``ECPSnapshot`` (``acquire``/``release``) so the serving scheduler can
    lease it across concurrent requests."""

    def __init__(self, parent: FederatedIndex):
        taken = []
        try:
            for name in parent._shard_names:
                taken.append((name, parent._shards[name].snapshot()))
        except BaseException:
            for _, s in taken:
                s.close()
            raise
        self._shard_names = [n for n, _ in taken]
        self._shard_objs = [s for _, s in taken]
        self._router_emb = parent._router_emb.copy()
        self._router_owner = parent._router_owner.copy()
        self._router_slices = list(parent._router_slices)
        self.metric = parent.metric
        self.b_min = parent.b_min
        self.top_m = parent.top_m
        self.probe_m = parent.probe_m
        self.generation = sum(s.generation for s in self._shard_objs)
        self._refs = 1
        self._lock = threading.Lock()

    @property
    def supports_snapshot(self) -> bool:
        return False  # already one; snapshot-of-snapshot is not a thing

    def acquire(self) -> "FederatedSnapshot":
        with self._lock:
            if self._refs <= 0:
                raise RuntimeError("FederatedSnapshot already released")
            self._refs += 1
        return self

    def release(self) -> None:
        with self._lock:
            self._refs -= 1
            drop = self._refs == 0
        if drop:
            for s in self._shard_objs:
                s.close()

    def close(self) -> None:
        self.release()

    def __enter__(self) -> "FederatedSnapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------------- build
def build_federation(
    data: np.ndarray,
    root,
    *,
    n_shards: int,
    cfg,
    item_ids: np.ndarray | None = None,
    backend: str = "blob",
    keep_fstore: bool = False,
    device="cuda",
) -> Path:
    """Split ``data`` into ``n_shards`` contiguous slices, build each as
    its own eCP index under ``root`` (``shard_0000`` ...), convert to the
    single-file blob form when ``backend="blob"``, and write the
    federation manifest.  Returns the federation root.

    Contiguous slicing keeps ids globally unique and (for shuffled
    collections) statistically uniform; callers wanting semantic shards
    can pass pre-partitioned data per shard through repeated
    ``adopt_shard`` instead.  Each shard's leaf assignment runs on
    ``device``, as ``build_index``'s does.
    """
    import shutil

    from .build import build_index
    from .store import convert

    dev = resolve_device(device)
    data = np.asarray(data, np.float32)
    n = len(data)
    if n_shards < 1 or n_shards > n:
        raise ValueError(f"n_shards must be in [1, {n}], got {n_shards}")
    if item_ids is None:
        item_ids = np.arange(n, dtype=np.int64)
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    bounds = np.linspace(0, n, n_shards + 1).astype(np.int64)
    entries = []
    for i in range(n_shards):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        name = f"shard_{i:04d}"
        fdir = root / name
        store = build_index(data[lo:hi], str(fdir), cfg, item_ids=item_ids[lo:hi], device=dev)
        store.close()
        if backend == "blob":
            blob = root / f"{name}.blob"
            convert(str(fdir), str(blob))
            if not keep_fstore:
                shutil.rmtree(fdir)
            entries.append({"name": name, "path": blob.name, "backend": "blob"})
        else:
            entries.append({"name": name, "path": name, "backend": "fstore"})
    manifest = FederationManifest(
        metric=cfg.metric, dim=int(data.shape[1]), dtype=cfg.storage_dtype, shards=entries
    )
    manifest.save(root)
    # one open/close pass fills in generations, counts, and router blocks
    fed = FederatedIndex(root, device=dev)
    fed._save_manifest()
    fed.close()
    return root
