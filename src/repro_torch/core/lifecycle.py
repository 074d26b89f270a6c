"""Index lifecycle — the mutable half of eCP-FS (the port's counterpart of
the reference's ``core/lifecycle.py``).

The paper's claim is that mapping the index to a transparent file structure
makes it easy to read, analyze, *and manipulate*; this module supplies the
manipulation: the one-shot in-memory build becomes one stage of a staged
lifecycle that also covers streaming construction, incremental mutation,
and compaction.

  * ``build_index(data, path, cfg)`` — the one-shot build (paper §3),
    unchanged semantics: leaders sampled uniformly at random, nested-prefix
    upper levels, top-down beam-1 insertion, written to the file structure.
  * ``build_index_streaming(source, path, cfg)`` — the same index built
    out-of-core: the collection arrives as an iterator of ``[B, D]``
    chunks and peak memory stays O(chunk + leaders), never O(collection).
    Three streaming passes: (1) count, (2) gather the sampled leaders,
    (3) assign + append items to leaf blocks through the Store protocol.
    Leader sampling defaults to the one-shot build's exact
    ``rng.choice(N, l)`` draw (possible once pass 1 knows N), so a
    streamed build is **bit-identical** to ``build_index`` over the same
    collection — chunk boundaries don't leak into the result because the
    assignment pass re-batches rows to ``cfg.insert_batch``.  With an
    explicit ``n_leaders``, pass 1 instead runs single-pass reservoir
    sampling (Algorithm R, ``reservoir_sample``) and the gather pass is
    skipped.  A one-shot (non-re-iterable) source is spooled to disk.
  * ``insert_items(index, vectors, ids)`` — route new vectors down the
    tree (beam-1, the build's own insertion rule), append to leaf blocks,
    and split any leaf that outgrows ``cluster_cap`` with a deterministic
    local 2-means step, registering the new centroid with the parent node.
  * ``delete_items(index, ids)`` — tombstones recorded in the index
    metadata; both traversal engines filter them during leaf scoring.
  * ``compact(index)`` — purge tombstones and rebalance split chains by
    deterministically rebuilding the tree from the index's own live
    items (spooled to disk, streamed back through the builder with the
    index's recorded seed/cap/levels).  Because the rebuild IS the build
    pipeline run over the logical collection in canonical (id-sorted)
    order, the compacted index answers queries **bit-identically** to a
    fresh ``build_index`` of the same logical collection — on either
    backend, under either traversal engine.  fstore compaction rewrites
    nodes in place through the Store protocol (freeing stale slots);
    blob compaction rebuilds into a scratch hierarchy and atomically
    replaces the blob file.

Leader sampling, spill, routing of inserts, splits and every write are
numpy copied from the reference, so files match it byte for byte; the
builds' leaf assignment (``_assign_level`` and the batched beam-1 descent
of ``_make_insert_fn``) runs as PyTorch on ``device``, in batches of
``cfg.insert_batch`` rows.

The mutation entry points here are free functions over a duck-typed
``ECPIndex`` (they use only its ``store``/``info``/``get_node``/cache
surface); ``ECPIndex.insert/delete/compact`` are thin wrappers.  The
*logical collection* of an index is its set of live ``(id, vector)``
pairs **in the storage dtype** (float16 by default): an inserted vector
is stored rounded, so that rounded value is what rebuilds compare equal.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, replace as dc_replace
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from . import layout
from .distances import np_distances, torch_distances
from .packed import PackedLevel, pack_children
from .store import BLOB_FILENAME, FStoreBackend, Store, convert, open_store

__all__ = [
    "ECPBuildConfig",
    "build_index",
    "build_index_streaming",
    "reservoir_sample",
    "insert_items",
    "delete_items",
    "compact",
]


@dataclass(frozen=True)
class ECPBuildConfig:
    levels: int = 2                  # L
    metric: str = "l2"
    cluster_cap: int | None = None   # target vectors per cluster (C/V)
    cluster_bytes: int | None = 128 * 1024  # C; used if cluster_cap is None
    storage_dtype: str = "float16"   # on-disk embedding dtype (paper stores f16)
    seed: int = 0
    insert_batch: int = 8192         # items per device batch during insertion
    leaf_chunk_rows: int | None = None  # one chunk per cluster by default
    spill_s: int = 0                 # max ADDITIONAL leaf replicas per vector:
                                     # border vectors near several leaders are
                                     # written into up to s extra leaves
    spill_eps: float = 0.25          # spill band vs the nearest-leader distance
                                     # d1: a leader at d_j qualifies when
                                     # d_j <= d1 + eps*|d1| (l2/cosine) or
                                     # d_j <= d1 + eps (ip)


def _resolve_cap(cfg: ECPBuildConfig, dim: int, itemsize: int) -> int:
    if cfg.cluster_cap is not None:
        return max(1, int(cfg.cluster_cap))
    assert cfg.cluster_bytes is not None
    return max(1, int(cfg.cluster_bytes) // (dim * itemsize))


@torch.no_grad()
def _assign_level(child_emb: torch.Tensor, parent_emb: torch.Tensor, metric: str) -> torch.Tensor:
    """Nearest parent centroid for each child centroid. [n_child] int64."""
    d = torch_distances(child_emb, parent_emb, metric)
    return torch.argmin(d, dim=-1)


def _make_insert_fn(
    root_emb: np.ndarray, internal: list[PackedLevel], metric: str, device: torch.device
):
    """Batched top-down traversal on ``device``: items -> leaf node indices
    (beam=1).  The returned function takes a [B, D] float32 tensor on
    ``device`` and returns [B] int64 leaf ids there."""
    root = torch.as_tensor(root_emb, dtype=torch.float32, device=device)
    embs = [torch.as_tensor(p.emb, device=device) for p in internal]
    idss = [torch.as_tensor(p.ids, device=device).long() for p in internal]
    masks = [torch.as_tensor(p.mask, device=device) for p in internal]

    @torch.no_grad()
    def insert(q: torch.Tensor) -> torch.Tensor:
        d = torch_distances(q, root, metric)                    # [B, n1]
        node = torch.argmin(d, dim=-1)                          # lvl_1 node
        for emb, ids, mask in zip(embs, idss, masks):
            ce = emb[node]                                      # [B, maxc, D]
            cd = torch_distances(q[:, None, :], ce, metric)[:, 0, :]  # [B, maxc]
            cd = torch.where(mask[node], cd, torch.inf)
            best = torch.argmin(cd, dim=-1)
            node = ids[node, best]                              # next-level node
        return node

    return insert


# ----------------------------------------------------------- shared stages
def _spill_targets(
    Q: np.ndarray,
    leader_emb: np.ndarray,
    primary: np.ndarray,
    s: int,
    eps: float,
    metric: str,
    *,
    leaf_ids: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Build-time spill assignment: for each row of ``Q``, the extra leaves
    (beyond its tree-routed ``primary``) it should be replicated into.

    Candidates are the row's nearest leaf leaders in ``(distance, leaf)``
    order; one qualifies when its distance ``d_j`` is within the eps band
    of the row's globally nearest leader distance ``d1`` — multiplicative
    for l2/cosine (``d_j <= d1 + eps*|d1|``), additive for ip — capped at
    ``s`` replicas.  Pure numpy (``np_distances`` per batch), so identical
    batches always produce identical assignments: the one-shot build, the
    streaming build, and compact()'s rebuild all re-batch rows the same
    way and therefore spill bit-identically.

    ``leaf_ids`` maps leader rows to leaf node ids (insert time, where the
    centroids come from the parent level); by default row j IS leaf j (the
    builds' leader array).  Returns ``(rows, leaves)`` index arrays.
    """
    s = int(s)
    if s <= 0 or len(Q) == 0 or len(leader_emb) < 2:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    d = np_distances(np.asarray(Q, np.float32), np.asarray(leader_emb, np.float32), metric)
    if d.ndim == 1:
        d = d[None, :]
    n, l = d.shape
    ids_of = np.arange(l, dtype=np.int64) if leaf_ids is None else np.asarray(leaf_ids, np.int64)
    take = min(s + 1, l)  # the primary is usually among the nearest
    if take < l:
        part = np.argpartition(d, take - 1, axis=1)[:, :take]
    else:
        part = np.broadcast_to(np.arange(l), (n, l))
    rows_out: list[int] = []
    leaves_out: list[int] = []
    for r in range(n):
        cand = part[r]
        dc = d[r, cand].astype(np.float64)
        o = np.lexsort((ids_of[cand], dc))  # by distance, ties by leaf id
        d1 = float(dc[o[0]])  # argpartition keeps the global nearest in cand
        thresh = d1 + eps if metric == "ip" else d1 + eps * abs(d1)
        p = int(primary[r])
        cnt = 0
        for oo in o:
            j = int(ids_of[cand[oo]])
            if j == p:
                continue
            if float(dc[oo]) > thresh:
                break
            rows_out.append(r)
            leaves_out.append(j)
            cnt += 1
            if cnt >= s:
                break
    return np.asarray(rows_out, np.int64), np.asarray(leaves_out, np.int64)


def _validate_build(n_items: int, dim: int, cfg: ECPBuildConfig, n_ids: int | None) -> None:
    if n_items == 0:
        raise ValueError(
            "cannot build an index over an empty collection (0 items)"
        )
    if dim < 1:
        raise ValueError(f"collection must be [N, D] with D >= 1, got dim {dim}")
    if cfg.levels < 1:
        raise ValueError(f"levels must be >= 1, got {cfg.levels}")
    if cfg.cluster_cap is not None and cfg.cluster_cap < 1:
        raise ValueError(f"cluster_cap must be >= 1, got {cfg.cluster_cap}")
    if n_ids is not None and n_ids != n_items:
        raise ValueError(
            f"item_ids length {n_ids} does not match collection size {n_items}"
        )
    if cfg.spill_s < 0:
        raise ValueError(f"spill_s must be >= 0, got {cfg.spill_s}")
    if cfg.spill_eps < 0:
        raise ValueError(f"spill_eps must be >= 0, got {cfg.spill_eps}")


def _hierarchy(
    leaders: np.ndarray, nodes_per_level, metric: str, device: torch.device
) -> list[list[np.ndarray]]:
    """Internal levels: nested prefixes + nearest-parent assignment (on
    ``device``).  children[i][j] = child node indices (at lvl_{i+2}) of
    node j at lvl_{i+1}."""
    lead = torch.as_tensor(leaders, dtype=torch.float32, device=device)
    children: list[list[np.ndarray]] = []
    for i in range(1, len(nodes_per_level)):
        n_parent = nodes_per_level[i - 1]
        n_child = nodes_per_level[i]
        assign = _assign_level(lead[:n_child], lead[:n_parent], metric).cpu().numpy()
        lists: list[list[int]] = [[] for _ in range(n_parent)]
        for child, parent in enumerate(assign):
            lists[int(parent)].append(child)
        children.append([np.asarray(x, np.int32) for x in lists])
    return children


def _write_skeleton(
    store,
    info: layout.IndexInfo,
    leaders: np.ndarray,
    leader_item_ids: np.ndarray,
    children: list[list[np.ndarray]],
    store_dt: np.dtype,
) -> None:
    """Info + representatives + root + internal levels (everything above
    the leaves — O(leaders) data)."""
    is_fstore = getattr(store, "fstore", None) is not None
    if is_fstore:
        store.create_group(layout.INFO, attrs=info.to_attrs())
        store.write_array(layout.REP_EMB, leaders.astype(store_dt), chunk_rows=4096)
        store.write_array(layout.REP_IDS, leader_item_ids.astype(np.int64), chunk_rows=65536)
    else:
        store.write_attrs(layout.INFO, info.to_attrs())
    root_emb = leaders[: info.nodes_per_level[0]]
    store.write_node(
        0, 0, root_emb.astype(store_dt), np.arange(len(root_emb), dtype=np.int32)
    )
    for i, lists in enumerate(children):
        lv = i + 1
        if is_fstore:
            store.create_group(layout.lvl_group(lv))
        for j, ids in enumerate(lists):
            store.write_node(lv, j, leaders[ids].astype(store_dt), ids.astype(np.int32))
    if is_fstore:
        store.create_group(layout.lvl_group(info.levels))


def _sample_positions(seed: int, n_items: int, n_leaders: int) -> np.ndarray:
    """The one-shot build's leader draw: uniform without replacement, in
    draw order (the order IS the leader numbering)."""
    if n_leaders > n_items:
        raise ValueError(
            f"cannot sample {n_leaders} leaders from {n_items} items; "
            "collection is smaller than the requested leader count"
        )
    return np.random.default_rng(seed).choice(n_items, size=n_leaders, replace=False)


def reservoir_sample(chunks, k: int, *, seed: int = 0):
    """Single-pass uniform sample WITHOUT replacement of ``k`` rows from an
    iterator of ``[B, D]`` chunks (Algorithm R, vectorized per chunk).

    Returns ``(sample [k', D] float32, positions [k'] int64, n_seen)`` with
    ``k' = min(k, n_seen)``.  O(k) memory — the streaming build's sampler
    when the leader count is known up front (``n_leaders=...``), since the
    exact one-shot draw needs the collection size before it can be made.
    """
    if k < 1:
        raise ValueError(f"reservoir size must be >= 1, got {k}")
    rng = np.random.default_rng(seed)
    sample: np.ndarray | None = None
    pos = np.empty(k, np.int64)
    t = 0  # rows seen so far
    for chunk in chunks:
        chunk = np.asarray(chunk, np.float32)
        if chunk.ndim != 2:
            raise ValueError(f"chunks must be [B, D], got shape {chunk.shape}")
        m = len(chunk)
        if m == 0:
            continue
        if sample is None:
            sample = np.empty((k, chunk.shape[1]), np.float32)
        at = 0
        if t < k:  # fill phase
            take = min(k - t, m)
            sample[t : t + take] = chunk[:take]
            pos[t : t + take] = np.arange(t, t + take)
            t += take
            at = take
        if at < m:  # replacement phase: row at global index g replaces a
            # reservoir slot with probability k / (g + 1)
            g = t + np.arange(m - at)
            js = (rng.random(m - at) * (g + 1)).astype(np.int64)
            for h in np.flatnonzero(js < k):  # few hits; sequential = exact R
                sample[js[h]] = chunk[at + h]
                pos[js[h]] = g[h]
            t += m - at
    if sample is None:
        raise ValueError("cannot sample from an empty collection")
    kk = min(k, t)
    return sample[:kk], pos[:kk], t


# ------------------------------------------------------------ chunk sources
class _ChunkSource:
    """Re-iterable view over a collection of ``[B, D]`` chunks.

    Accepts an ndarray (sliced into ``chunk_rows`` views), a sequence of
    arrays, a callable returning a fresh iterator per pass, or a one-shot
    iterator — the latter is spooled to a scratch directory during the
    first pass so later passes can re-read it (out-of-core, not in RAM).
    Chunks may be ``(emb, ids)`` pairs; otherwise ids are the global row
    positions (or ``item_ids`` indexed by position).
    """

    def __init__(self, source, *, item_ids=None, chunk_rows: int = 8192):
        self._item_ids = None if item_ids is None else np.asarray(item_ids, np.int64)
        self._chunk_rows = max(1, int(chunk_rows))
        self.saw_pairs = False  # source yields (emb, ids) tuples
        self._spool: tempfile.TemporaryDirectory | None = None
        self._spooled: list[tuple[str, str]] = []
        self._array = None
        self._seq = None
        self._fn = None
        self._iter = None
        if isinstance(source, np.ndarray):
            self._array = source
        elif callable(source):
            self._fn = source
        elif isinstance(source, (list, tuple)):
            self._seq = source
        else:
            self._iter = iter(source)

    def _norm(self, raw, offset: int):
        if isinstance(raw, tuple):
            self.saw_pairs = True
            emb, ids = raw
            emb = np.asarray(emb, np.float32)
            ids = np.asarray(ids, np.int64)
            if len(emb) != len(ids):
                raise ValueError(f"chunk emb/ids length mismatch: {len(emb)} vs {len(ids)}")
        else:
            emb = np.asarray(raw, np.float32)
            if self._item_ids is not None:
                ids = self._item_ids[offset : offset + len(emb)]
            else:
                ids = np.arange(offset, offset + len(emb), dtype=np.int64)
        if emb.ndim != 2:
            raise ValueError(f"chunks must be [B, D], got shape {emb.shape}")
        return emb, ids

    def chunks(self):
        """One pass over the collection as (emb f32 [B, D], ids [B])."""
        offset = 0
        if self._array is not None:
            a = self._array
            for lo in range(0, len(a), self._chunk_rows):
                emb, ids = self._norm(a[lo : lo + self._chunk_rows], lo)
                yield emb, ids
        elif self._seq is not None or self._fn is not None:
            it = self._seq if self._seq is not None else self._fn()
            for raw in it:
                emb, ids = self._norm(raw, offset)
                offset += len(emb)
                yield emb, ids
        elif self._iter is not None:
            # one-shot iterator: consume + spool to disk for later passes
            self._spool = tempfile.TemporaryDirectory(prefix="ecpfs_spool_")
            root = Path(self._spool.name)
            it, self._iter = self._iter, None
            for i, raw in enumerate(it):
                emb, ids = self._norm(raw, offset)
                offset += len(emb)
                pe, pi = str(root / f"{i:06d}_emb.npy"), str(root / f"{i:06d}_ids.npy")
                np.save(pe, emb)  # lossless: replayed passes must see the
                np.save(pi, ids)  # exact values the first pass counted
                self._spooled.append((pe, pi))
                yield emb, ids
        else:  # replay the spool
            for pe, pi in self._spooled:
                yield np.load(pe).astype(np.float32), np.load(pi)


# ------------------------------------------------------------------- builds
def build_index(
    data: np.ndarray,
    path: str,
    cfg: ECPBuildConfig = ECPBuildConfig(),
    *,
    item_ids: np.ndarray | None = None,
    device="cuda",
) -> FStoreBackend:
    """Build an eCP-FS index over ``data`` [N, D] at directory ``path``.

    The leaf assignment runs on ``device`` ("cuda" by default, "cpu" when
    asked); the files written are the reference build's, byte for byte,
    whenever the two packages' float32 distances pick the same nearest
    leaders.  ``convert()`` serializes the result for the blob backend.
    """
    return _build_one_shot(data, path, cfg, item_ids=item_ids, device=device)


def _build_one_shot(data, path, cfg, *, item_ids=None, device="cuda", generation: int = 0,
                    next_id: int | None = None) -> FStoreBackend:
    """``build_index``, with the generation counter and the floor of the
    default-id allocator that a compaction carries forward (as
    ``build_index_streaming`` takes them)."""
    dev = resolve_device(device)
    data = np.asarray(data)
    if data.ndim != 2:
        raise ValueError(f"collection must be [N, D], got shape {data.shape}")
    n_items, dim = data.shape
    _validate_build(n_items, dim, cfg, None if item_ids is None else len(item_ids))
    if item_ids is None:
        item_ids = np.arange(n_items, dtype=np.int64)
    else:
        item_ids = np.asarray(item_ids, np.int64)
    store_dt = np.dtype(cfg.storage_dtype)
    cap = _resolve_cap(cfg, dim, store_dt.itemsize)
    n_leaders, fanout, nodes_per_level = layout.derive_shape(n_items, cap, cfg.levels)

    leader_idx = _sample_positions(cfg.seed, n_items, n_leaders)
    leaders = np.asarray(data[leader_idx], np.float32)         # [l, D]
    children = _hierarchy(leaders, nodes_per_level, cfg.metric, dev)

    # --- item insertion: batched beam-1 traversal -------------------------
    internal_packed = [
        pack_children([leaders[ids] for ids in lists], lists, dim)
        for lists in children
    ]
    insert = _make_insert_fn(leaders[: nodes_per_level[0]], internal_packed, cfg.metric, dev)
    # (row, leaf) assignment pairs, built PER insert batch: each batch
    # contributes its primary assignments in row order, then its spill
    # replicas, so the final stable sort by leaf groups rows exactly as
    # the reference's builds do.
    pair_rows_l: list[np.ndarray] = []
    pair_leaf_l: list[np.ndarray] = []
    for lo in range(0, n_items, cfg.insert_batch):
        hi = min(lo + cfg.insert_batch, n_items)
        q = torch.as_tensor(np.asarray(data[lo:hi], np.float32)).to(dev)
        leaf_b = insert(q).cpu().numpy().astype(np.int64)
        pair_rows_l.append(np.arange(lo, hi, dtype=np.int64))
        pair_leaf_l.append(leaf_b)
        if cfg.spill_s > 0:
            sr, slv = _spill_targets(
                np.asarray(data[lo:hi], np.float32), leaders, leaf_b,
                cfg.spill_s, cfg.spill_eps, cfg.metric,
            )
            pair_rows_l.append(sr + lo)
            pair_leaf_l.append(slv)
    pair_rows = np.concatenate(pair_rows_l)
    pair_leaf = np.concatenate(pair_leaf_l)

    # --- write the file structure -----------------------------------------
    store = open_store(path, backend="fstore", create=True)
    info = layout.IndexInfo(
        levels=cfg.levels,
        metric=cfg.metric,
        dim=dim,
        dtype=str(store_dt),
        n_items=n_items,
        cluster_cap=cap,
        n_leaders=n_leaders,
        fanout=fanout,
        nodes_per_level=nodes_per_level,
        seed=cfg.seed,
        generation=generation,
        insert_batch=cfg.insert_batch,
        next_id=max(int(item_ids.max()) + 1, next_id or 0),
        spill_s=max(0, int(cfg.spill_s)),
        spill_eps=float(cfg.spill_eps),
    )
    _write_skeleton(store, info, leaders, item_ids[leader_idx], children, store_dt)
    order = np.argsort(pair_leaf, kind="stable")
    sorted_leaf = pair_leaf[order]
    bounds = np.searchsorted(sorted_leaf, np.arange(n_leaders + 1))
    for j in range(n_leaders):
        members = pair_rows[order[bounds[j] : bounds[j + 1]]]
        store.write_node(
            cfg.levels,
            j,
            np.asarray(data[members], store_dt),
            item_ids[members].astype(np.int64),
            chunk_rows=cfg.leaf_chunk_rows,
        )
    return store


def build_index_streaming(
    source,
    path: str | None = None,
    cfg: ECPBuildConfig = ECPBuildConfig(),
    *,
    item_ids: np.ndarray | None = None,
    store: Store | None = None,
    n_leaders: int | None = None,
    generation: int = 0,
    next_id: int | None = None,
    device="cuda",
) -> Store:
    """Out-of-core build: consume the collection as ``[B, D]`` chunks with
    peak memory O(chunk + leaders + insert_batch), never O(collection).

    ``source``: an ndarray, a sequence of chunks, a callable returning a
    fresh chunk iterator per pass, or a one-shot iterator (spooled to a
    scratch directory on the first pass).  Chunks may be ``(emb, ids)``
    pairs.  Items are appended to leaf blocks through the Store protocol
    as they are assigned — no cluster is ever materialized in RAM.

    Default sampling draws the one-shot build's exact leader set once
    pass 1 has counted the collection, so the result is bit-identical to
    ``build_index`` over the same data (same seed, any chunking).  An
    explicit ``n_leaders`` switches pass 1 to single-pass reservoir
    sampling instead (one fewer pass; leaders then differ from the
    one-shot draw).

    ``store`` writes into an existing (fstore-protocol) store in place —
    the compaction path; otherwise ``path`` is created.  ``generation``
    seeds the written index's generation counter and ``next_id`` floors
    its default-id allocator (compaction carries both forward, so purged
    ids are never reissued).  The leaf assignment runs on ``device``, as in
    ``build_index``.
    """
    dev = resolve_device(device)
    if (path is None) == (store is None):
        raise ValueError("exactly one of path / store must be given")
    src = _ChunkSource(source, item_ids=item_ids, chunk_rows=cfg.insert_batch)

    # ---- pass 1: count (and, with explicit n_leaders, reservoir-sample)
    reservoir = None
    n_items = 0
    dim = 0
    max_id = -1
    if n_leaders is not None:
        def counting():
            nonlocal n_items, dim, max_id
            for emb, ids in src.chunks():
                n_items += len(emb)
                dim = emb.shape[1]
                if len(ids):
                    max_id = max(max_id, int(ids.max()))
                yield emb

        leaders, leader_pos, _ = reservoir_sample(counting(), n_leaders, seed=cfg.seed)
        reservoir = (leaders, leader_pos)
        if n_leaders > n_items:
            raise ValueError(
                f"cannot sample {n_leaders} leaders from {n_items} items; "
                "collection is smaller than the requested leader count"
            )
    else:
        for emb, ids in src.chunks():
            n_items += len(emb)
            dim = emb.shape[1]
            if len(ids):
                max_id = max(max_id, int(ids.max()))
    if n_items == 0:
        raise ValueError("cannot build an index over an empty collection (0 items)")
    _validate_build(n_items, dim, cfg, None)
    store_dt = np.dtype(cfg.storage_dtype)
    cap = _resolve_cap(cfg, dim, store_dt.itemsize)
    n_l, fanout, nodes_per_level = layout.derive_shape(
        n_items, cap, cfg.levels, n_leaders=n_leaders
    )

    # ---- pass 2: gather the sampled leader rows (skipped in reservoir
    # mode: the reservoir already holds the embeddings, and the sampled
    # ids are derivable without re-streaming unless the source itself
    # yields (emb, ids) pairs)
    if reservoir is not None:
        leaders, leader_pos = reservoir
        if item_ids is not None:
            leader_item_ids = np.asarray(item_ids, np.int64)[leader_pos]
        elif src.saw_pairs:
            leader_item_ids = _gather_ids(src, leader_pos)
        else:  # default ids ARE the positions
            leader_item_ids = leader_pos.astype(np.int64)
    else:
        leader_pos = _sample_positions(cfg.seed, n_items, n_l)
        leaders, leader_item_ids = _gather_rows(src, leader_pos, dim)

    children = _hierarchy(leaders, nodes_per_level, cfg.metric, dev)
    internal_packed = [
        pack_children([leaders[ids] for ids in lists], lists, dim)
        for lists in children
    ]
    insert = _make_insert_fn(leaders[: nodes_per_level[0]], internal_packed, cfg.metric, dev)

    if store is None:
        store = open_store(path, backend="fstore", create=True)
    info = layout.IndexInfo(
        levels=cfg.levels,
        metric=cfg.metric,
        dim=dim,
        dtype=str(store_dt),
        n_items=n_items,
        cluster_cap=cap,
        n_leaders=n_l,
        fanout=fanout,
        nodes_per_level=nodes_per_level,
        seed=cfg.seed,
        generation=generation,
        insert_batch=cfg.insert_batch,
        next_id=max(max_id + 1, next_id or 0),
        spill_s=max(0, int(cfg.spill_s)),
        spill_eps=float(cfg.spill_eps),
    )
    _write_skeleton(store, info, leaders, leader_item_ids, children, store_dt)

    # ---- pass 3: assign + append.  Rows are re-batched to cfg.insert_batch
    # so the device assignment sees the one-shot build's exact batch
    # sequence — chunk boundaries cannot perturb the result.
    L = cfg.levels
    leaf_chunk = cfg.leaf_chunk_rows or cap
    touched = np.zeros(n_l, bool)
    is_fstore = getattr(store, "fstore", None) is not None
    buf_q = np.empty((cfg.insert_batch, dim), np.float32)
    buf_ids = np.empty(cfg.insert_batch, np.int64)
    fill = 0

    def flush() -> None:
        nonlocal fill
        if fill == 0:
            return
        q, ids_b = buf_q[:fill], buf_ids[:fill]
        leaf = insert(torch.as_tensor(q).to(dev)).cpu().numpy().astype(np.int64)
        rows_all = np.arange(fill, dtype=np.int64)
        leaf_all = leaf
        if cfg.spill_s > 0:
            # spill replicas append AFTER this batch's primaries — the
            # same (batch-primaries, batch-spills) order build_index's
            # pair list records, so both builds write identical leaves
            sr, slv = _spill_targets(
                q, leaders, leaf, cfg.spill_s, cfg.spill_eps, cfg.metric
            )
            rows_all = np.concatenate([rows_all, sr])
            leaf_all = np.concatenate([leaf, slv])
        order = np.argsort(leaf_all, kind="stable")
        sl = leaf_all[order]
        starts = np.flatnonzero(np.r_[True, sl[1:] != sl[:-1]])
        for s, e in zip(starts, np.r_[starts[1:], len(sl)]):
            j = int(sl[s])
            rows = rows_all[order[s:e]]
            emb_w = q[rows].astype(store_dt)
            ids_w = ids_b[rows]
            if touched[j]:
                store.append_rows(L, j, emb_w, ids_w)
            elif is_fstore:
                # first touch replaces whatever a previous tree left here
                store.write_node(L, j, emb_w, ids_w, chunk_rows=leaf_chunk)
                touched[j] = True
            else:
                store.write_node(L, j, emb_w, ids_w)
                touched[j] = True
        fill = 0

    for emb, ids in src.chunks():
        at = 0
        while at < len(emb):
            take = min(cfg.insert_batch - fill, len(emb) - at)
            buf_q[fill : fill + take] = emb[at : at + take]
            buf_ids[fill : fill + take] = ids[at : at + take]
            fill += take
            at += take
            if fill == cfg.insert_batch:
                flush()
    flush()

    # empty clusters still get (empty) nodes, exactly like the one-shot build
    empty_e = np.zeros((0, dim), store_dt)
    empty_i = np.zeros((0,), np.int64)
    for j in np.flatnonzero(~touched):
        if is_fstore:
            store.write_node(L, int(j), empty_e, empty_i, chunk_rows=leaf_chunk)
        else:
            store.write_node(L, int(j), empty_e, empty_i)
    return store


def _gather_rows(src: _ChunkSource, positions: np.ndarray, dim: int):
    """One streaming pass collecting the rows at ``positions`` (and their
    ids), returned in ``positions`` order — O(len(positions)) memory."""
    srt = np.argsort(positions, kind="stable")
    sorted_pos = positions[srt]
    out = np.empty((len(positions), dim), np.float32)
    out_ids = np.empty(len(positions), np.int64)
    seen = 0
    offset = 0
    for emb, ids in src.chunks():
        lo = np.searchsorted(sorted_pos, offset)
        hi = np.searchsorted(sorted_pos, offset + len(emb))
        if hi > lo:
            rel = sorted_pos[lo:hi] - offset
            out[srt[lo:hi]] = emb[rel]
            out_ids[srt[lo:hi]] = ids[rel]
            seen += hi - lo
        offset += len(emb)
    if seen != len(positions):
        raise ValueError(
            f"chunk source changed between passes: gathered {seen} of "
            f"{len(positions)} sampled rows"
        )
    return out, out_ids


def _gather_ids(src: _ChunkSource, positions: np.ndarray) -> np.ndarray:
    """Ids at ``positions`` without re-reading embeddings into the result."""
    srt = np.argsort(positions, kind="stable")
    sorted_pos = positions[srt]
    out_ids = np.empty(len(positions), np.int64)
    seen = 0
    offset = 0
    for _emb, ids in src.chunks():
        lo = np.searchsorted(sorted_pos, offset)
        hi = np.searchsorted(sorted_pos, offset + len(ids))
        if hi > lo:
            out_ids[srt[lo:hi]] = ids[sorted_pos[lo:hi] - offset]
            seen += hi - lo
        offset += len(ids)
    if seen != len(positions):
        raise ValueError(
            f"chunk source changed between passes: gathered {seen} of "
            f"{len(positions)} sampled rows"
        )
    return out_ids


# ---------------------------------------------------------------- mutation
def publish_generation(index, attrs: dict, new_info, tombstones: set, written) -> None:
    """THE commit point of every non-structural mutation.

    A mutation becomes visible — to this process's searchers, to the
    serving scheduler's snapshot manager, and to EXTERNAL readers of the
    blob file — at the single ``write_attrs`` below, which publishes the
    bumped ``generation`` together with the new counts, node registry, and
    tombstone list atomically (one header rewrite on blob, one tmp+replace
    JSON write on fstore).  Until this write, appended rows and
    split-created leaves exist on disk but are unreachable: the old info
    still describes the old tree, so a reader (or a crash) that never sees
    the new attrs never sees a half-applied mutation.

    External readers of the blob format poll ``info.generation`` and call
    ``ECPIndex.refresh()`` when it moves; ``launch/scheduler.py`` instead
    re-pins a fresh ``ECPIndex.snapshot()`` after each mutation returns.
    ``_apply_mutation`` then updates this process's in-memory state (cache
    invalidation + cache-key version bumps + metadata/root refresh).

    Structural rewrites (``compact``) have their own commit points: the
    fstore rebuild's final info write, or the blob's ``os.replace`` swap.
    """
    attrs.update(new_info.to_attrs())
    index.store.write_attrs(layout.INFO, layout.write_tombstones(attrs, tombstones))
    index._apply_mutation(new_info, written, tombstones=tombstones)


def _node_rows(index, keys: list) -> list[int]:
    rows_fn = getattr(index.store, "node_rows", None)
    if rows_fn is not None:
        return rows_fn(keys)
    return [len(ids) for _, ids in index.store.get_nodes(keys)]


def _route_batch(index, Q: np.ndarray):
    """Beam-1 descent for a batch: [n, D] -> (leaf ids [n], parent_of).

    ``parent_of[leaf] = (level, node)`` of the internal node whose child
    list holds the leaf (the root ``(0, 0)`` for a 1-level index) — the
    node a split must register its new centroid with.  Internal children
    with no children of their own are skipped (next-nearest wins), so
    routing never dead-ends in an empty subtree.
    """
    info = index.info
    metric = info.metric
    L = info.levels
    n = len(Q)
    d = np_distances(Q, index.root_emb, metric)
    d = d[None, :] if d.ndim == 1 else d
    if L == 1:
        best = np.argmin(d, axis=1)
        leaf = np.asarray(index.root_ids, np.int64)[best]
        return leaf, {int(j): (0, 0) for j in np.unique(leaf)}
    rows1 = np.asarray(_node_rows(index, [(1, int(c)) for c in index.root_ids]))
    dd = np.where(rows1[None, :] == 0, np.inf, d)
    if not np.isfinite(dd).any(axis=1).all():
        raise RuntimeError("index has no reachable leaves from the root")
    cur = np.asarray(index.root_ids, np.int64)[np.argmin(dd, axis=1)]
    parent_of: dict[int, tuple[int, int]] = {}
    for lv in range(1, L):
        child_level = lv + 1
        nxt = np.empty(n, np.int64)
        for nd in np.unique(cur):
            rows_i = np.flatnonzero(cur == nd)
            emb, ids = index.get_node(lv, int(nd))
            if len(ids) == 0:
                raise RuntimeError(
                    f"routing reached empty internal node (lvl {lv}, node {int(nd)})"
                )
            d = np_distances(Q[rows_i], emb, metric)
            d = d[None, :] if d.ndim == 1 else d
            if child_level < L:
                rows_c = np.asarray(_node_rows(index, [(child_level, int(c)) for c in ids]))
                d = np.where(rows_c[None, :] == 0, np.inf, d)
                if not np.isfinite(d).any(axis=1).all():
                    raise RuntimeError(
                        f"no reachable leaves under internal node (lvl {lv}, node {int(nd)})"
                    )
            best = np.argmin(d, axis=1)
            chosen = np.asarray(ids, np.int64)[best]
            nxt[rows_i] = chosen
            if child_level == L:
                for j in np.unique(chosen):
                    parent_of[int(j)] = (lv, int(nd))
        cur = nxt
    return cur, parent_of


def _two_means(emb: np.ndarray, iters: int = 8):
    """Deterministic local 2-means: farthest-point init, Lloyd iterations,
    ties to side 0.  Returns (mask_side0, centroid0, centroid1); degenerate
    inputs (all rows identical) fall back to an index-halves split."""
    n = len(emb)
    halves = np.zeros(n, bool)
    halves[: (n + 1) // 2] = True
    mu = emb.mean(0)
    i0 = int(np.argmax(((emb - mu) ** 2).sum(1)))
    i1 = int(np.argmax(((emb - emb[i0]) ** 2).sum(1)))
    if not ((emb[i0] - emb[i1]) ** 2).sum() > 0:
        return halves, emb[halves].mean(0), emb[~halves].mean(0)
    c0, c1 = emb[i0].copy(), emb[i1].copy()
    m = halves
    for _ in range(iters):
        d0 = ((emb - c0) ** 2).sum(1)
        d1 = ((emb - c1) ** 2).sum(1)
        m = d0 <= d1
        if m.all() or not m.any():
            return halves, emb[halves].mean(0), emb[~halves].mean(0)
        nc0, nc1 = emb[m].mean(0), emb[~m].mean(0)
        if np.array_equal(nc0, c0) and np.array_equal(nc1, c1):
            break
        c0, c1 = nc0, nc1
    return m, c0, c1


def _split_parts(emb: np.ndarray, ids: np.ndarray, cap: int) -> list:
    """Recursively 2-means-split until every part holds <= cap rows.
    Returns [(emb, ids, centroid), ...] in deterministic order."""
    if len(emb) <= cap:
        return [(emb, ids, emb.mean(0) if len(emb) else np.zeros(emb.shape[1], np.float32))]
    m, c0, c1 = _two_means(emb)
    return _split_parts(emb[m], ids[m], cap) + _split_parts(emb[~m], ids[~m], cap)


def _split_leaf(index, ctx: dict, leaf: int, emb: np.ndarray, ids: np.ndarray, parent) -> None:
    """Split one over-full leaf: part 0 stays at ``leaf``, the rest become
    new nodes at the end of the leaf level; the parent's routing row for
    ``leaf`` becomes part 0's centroid and one row per new node is
    appended (paper's tree stays valid: internal ids keep pointing at
    next-level nodes)."""
    info = index.info
    L = info.levels
    dt = np.dtype(info.dtype)
    cap = max(1, info.cluster_cap)
    parts = _split_parts(np.asarray(emb, np.float32), np.asarray(ids, np.int64), cap)
    store = index.store
    # pre-flight BEFORE any write: a fixed-block backend must fit both the
    # grown parent and the new nodes' header growth (slot map, v1→v2
    # upgrade), or the split would strand already-written data — the leaf
    # is overwritten with part 0 first, so a late failure loses rows
    cap_rows = getattr(store, "capacity_rows", None)
    if cap_rows is not None:
        p_rows = _node_rows(index, [parent])[0]
        if p_rows + len(parts) - 1 > cap_rows:
            raise ValueError(
                f"splitting leaf {leaf} would grow its parent "
                f"(lvl {parent[0]}, node {parent[1]}) to {p_rows + len(parts) - 1} "
                f"rows, past the blob's fixed block ({cap_rows} rows); "
                "compact() the index to rebalance before further inserts"
            )
    ensure = getattr(store, "ensure_capacity", None)
    if ensure is not None:
        ensure(L, len(parts) - 1)
    store.write_node(L, leaf, parts[0][0].astype(dt), parts[0][1])
    ctx["written"].add((L, leaf))
    new_nodes = []
    for p_emb, p_ids, _c in parts[1:]:
        j = ctx["npl"][-1]
        ctx["npl"][-1] += 1
        store.write_node(L, j, p_emb.astype(dt), p_ids)
        ctx["written"].add((L, j))
        new_nodes.append(j)
    ctx["splits"] += len(new_nodes)
    # register the new centroids with the parent
    p_lv, p_nd = parent
    p_emb, p_ids = store.get_node(p_lv, p_nd)
    pos = np.flatnonzero(np.asarray(p_ids, np.int64) == leaf)
    if len(pos) != 1:
        raise RuntimeError(
            f"parent (lvl {p_lv}, node {p_nd}) does not list leaf {leaf} exactly once"
        )
    p_emb = np.asarray(p_emb, np.float32)
    p_emb[pos[0]] = parts[0][2]
    add_emb = np.stack([c for _, _, c in parts[1:]])
    new_emb = np.concatenate([p_emb, add_emb]).astype(dt)
    new_ids = np.concatenate([np.asarray(p_ids), np.asarray(new_nodes, p_ids.dtype)])
    store.write_node(p_lv, p_nd, new_emb, new_ids)
    ctx["written"].add((p_lv, p_nd))


def _leaf_leaders(index) -> tuple[np.ndarray, np.ndarray]:
    """Leaf-leader centroids and their leaf node ids, read from the parent
    level (the root when levels == 1) through the index's node cache —
    the same pre-mutation tree view beam routing uses."""
    info = index.info
    L = info.levels
    if L == 1:
        return (
            np.asarray(index.root_emb, np.float32),
            np.asarray(index.root_ids, np.int64),
        )
    embs: list[np.ndarray] = []
    idss: list[np.ndarray] = []
    for nd in range(info.nodes_per_level[L - 2]):
        e, i = index.get_node(L - 1, nd)
        if len(i):
            embs.append(np.asarray(e, np.float32))
            idss.append(np.asarray(i, np.int64))
    return np.concatenate(embs), np.concatenate(idss)


def insert_items(index, vectors: np.ndarray, ids: np.ndarray | None = None) -> dict:
    """Insert ``vectors`` [n, D] (or [D]) with item ``ids`` into a live
    index: beam-1 routing to the nearest leaf, append through the Store
    protocol, deterministic 2-means splits for leaves that outgrow
    ``cluster_cap``.  Without explicit ids, new items take the positions
    ``n_items ..`` (correct for indexes built with default ids).

    Inserting a tombstoned id resurrects it: the tombstone is dropped and
    the id's OLD physical row is purged first (one scan of the leaf
    level), so the new row is the only live one and ``compact()`` never
    sees a duplicate.  Returns counters: inserted / splits / leaves /
    generation.
    """
    Q = np.asarray(vectors, np.float32)
    if Q.ndim == 1:
        Q = Q[None, :]
    info = index.info
    if Q.ndim != 2 or (len(Q) and Q.shape[1] != info.dim):
        raise ValueError(f"vectors must be [n, {info.dim}], got {list(Q.shape)}")
    n = len(Q)
    if ids is None:
        # next_id is monotonic across mutations AND compaction, so default
        # ids never collide with a live item (or reuse a purged one)
        ids = np.arange(info.next_id, info.next_id + n, dtype=np.int64)
    else:
        ids = np.asarray(ids, np.int64)
        if ids.shape != (n,):
            raise ValueError(f"ids must be [n]={n}, got {list(ids.shape)}")
        if len(np.unique(ids)) != n:
            raise ValueError("inserted ids must be unique")
    if n == 0:
        return {"inserted": 0, "splits": 0, "leaves": 0, "generation": info.generation}
    drain = getattr(index.store, "drain", None)
    if drain is not None:
        drain()  # no in-flight prefetch may land stale payloads mid-mutation

    attrs = index.store.read_attrs(layout.INFO)
    tombs = layout.read_tombstones(attrs)
    resurrected = tombs & {int(x) for x in ids}
    purged_keys: set = set()
    purged_rows = 0     # physical rows removed (spill replicas count each)
    purged_logical = 0  # distinct resurrected ids actually found + purged
    # ids below the allocator's floor may already exist in the index; one
    # pass over the leaf level finds them.  Tombstoned hits are purged
    # (the resurrect path — the new row must be the only one); LIVE hits
    # are an error and are detected BEFORE anything is written.
    suspects = {int(x) for x in ids if x < info.next_id}
    if suspects:
        sus_arr = np.fromiter(suspects, np.int64, len(suspects))
        L0 = info.levels
        hits: list[tuple[tuple, np.ndarray]] = []
        found: set = set()
        for lo in range(0, info.nodes_per_level[-1], 64):
            keys = [(L0, j) for j in range(lo, min(lo + 64, info.nodes_per_level[-1]))]
            for (lv, nd), (_e, nids) in zip(keys, index.store.get_nodes(keys)):
                if len(nids) == 0:
                    continue
                present = np.asarray(nids, np.int64)[
                    np.isin(np.asarray(nids, np.int64), sus_arr)
                ]
                if len(present):
                    hits.append(((lv, nd), present))
                    found |= {int(x) for x in present}
        live_dupes = found - resurrected
        if live_dupes:
            raise ValueError(
                f"ids already live in the index: {sorted(live_dupes)[:10]}"
                f"{'...' if len(live_dupes) > 10 else ''}; delete() them first"
            )
        if resurrected:
            res_arr = np.fromiter(resurrected, np.int64, len(resurrected))
            for key, present in hits:
                purged_rows += index.store.delete_rows(key[0], key[1], res_arr)
                purged_keys.add(key)
            purged_logical = len(found & resurrected)
    # a resurrected id above the allocator floor (or a phantom tombstone)
    # has no physical row to purge, but its tombstone must still drop —
    # the row being inserted now is the live one
    tombs -= resurrected

    leaf, parent_of = _route_batch(index, Q)
    L = info.levels
    dt = np.dtype(info.dtype)
    cap = max(1, info.cluster_cap)
    # spill replica plan, computed against the SAME pre-mutation tree view
    # beam routing used.  Replication at insert time is best-effort: a
    # target leaf at capacity is skipped rather than split (a replica is
    # a recall hint, never worth a structural change).
    spill_pairs: list[tuple[int, np.ndarray]] = []
    if info.spill_s > 0:
        lead_emb, lead_ids = _leaf_leaders(index)
        sr, slv = _spill_targets(
            Q, lead_emb, leaf.astype(np.int64),
            info.spill_s, info.spill_eps, info.metric, leaf_ids=lead_ids,
        )
        if len(sr):
            so = np.argsort(slv, kind="stable")
            ssr, ssl = sr[so], slv[so]
            st = np.flatnonzero(np.r_[True, ssl[1:] != ssl[:-1]])
            for s0, e0 in zip(st, np.r_[st[1:], len(ssl)]):
                spill_pairs.append((int(ssl[s0]), ssr[s0:e0]))
    ctx = {"npl": list(info.nodes_per_level), "written": set(), "splits": 0}
    order = np.argsort(leaf, kind="stable")
    sl = leaf[order]
    starts = np.flatnonzero(np.r_[True, sl[1:] != sl[:-1]])
    touched_leaves = 0
    appended = 0  # rows of COMPLETED leaf groups (the abort path records them)
    spilled = 0   # replica rows actually placed (capacity permitting)
    try:
        for s, e in zip(starts, np.r_[starts[1:], len(sl)]):
            j = int(sl[s])
            rows = order[s:e]
            touched_leaves += 1
            rows_now = _node_rows(index, [(L, j)])[0]
            if rows_now + len(rows) <= cap:
                index.store.append_rows(L, j, Q[rows].astype(dt), ids[rows])
                ctx["written"].add((L, j))
            else:
                old_emb, old_ids = index.store.get_node(L, j)
                all_emb = np.concatenate([np.asarray(old_emb, np.float32), Q[rows]])
                all_ids = np.concatenate([np.asarray(old_ids, np.int64), ids[rows]])
                _split_leaf(index, ctx, j, all_emb, all_ids, parent_of[j])
            appended += len(rows)
        for j, rows in spill_pairs:
            fit = cap - _node_rows(index, [(L, j)])[0]
            if fit <= 0:
                continue
            rows = rows[:fit]
            index.store.append_rows(L, j, Q[rows].astype(dt), ids[rows])
            ctx["written"].add((L, j))
            spilled += len(rows)
    except Exception:
        # partial failure (e.g. a later split refused by a full parent
        # block): the prefix that DID complete must be recorded — its
        # split-created leaves would otherwise sit outside the registered
        # nodes_per_level and compact() would drop their rows — and the
        # rewritten nodes must not be served stale from the cache
        try:
            part_info = dc_replace(
                info,
                n_items=info.n_items + appended - purged_logical,
                n_leaders=ctx["npl"][-1],
                nodes_per_level=tuple(ctx["npl"]),
                generation=info.generation + 1,
                next_id=max(info.next_id, int(ids.max()) + 1),
            )
            publish_generation(index, attrs, part_info, tombs, ctx["written"] | purged_keys)
        except Exception:
            index._apply_mutation(None, ctx["written"] | purged_keys)
        raise

    # metadata: counts, id allocator, generation, resurrected tombstones.
    # n_items tracks LOGICAL items: +n inserted, -ids actually purged (a
    # resurrected id that never physically existed purges nothing; spill
    # replicas are extra physical rows of the same item, never counted).
    new_info = dc_replace(
        info,
        n_items=info.n_items + n - purged_logical,
        n_leaders=ctx["npl"][-1],
        nodes_per_level=tuple(ctx["npl"]),
        generation=info.generation + 1,
        next_id=max(info.next_id, int(ids.max()) + 1),
    )
    publish_generation(index, attrs, new_info, tombs, ctx["written"] | purged_keys)
    return {
        "inserted": n,
        "splits": ctx["splits"],
        "leaves": touched_leaves,
        "spilled": spilled,
        "generation": new_info.generation,
    }


def delete_items(index, ids) -> int:
    """Tombstone ``ids``: the rows stay on disk but both traversal engines
    filter them during leaf scoring; ``compact()`` purges them physically.
    Returns the number of newly tombstoned ids.  Ids are not checked for
    liveness (a delete of an absent id is a harmless no-op tombstone)."""
    ids = np.unique(np.asarray(ids, np.int64).reshape(-1))
    attrs = index.store.read_attrs(layout.INFO)
    tombs = layout.read_tombstones(attrs)
    before = len(tombs)
    tombs |= {int(x) for x in ids}
    added = len(tombs) - before
    if added == 0:
        return 0
    new_info = dc_replace(index.info, generation=index.info.generation + 1)
    publish_generation(index, attrs, new_info, tombs, ())
    return added


def compact(index) -> dict:
    """Rewrite the index as a deterministic rebuild of its live items.

    Tombstoned rows are purged, split chains rebalanced, and the result
    answers queries bit-identically to a fresh ``build_index`` over the
    same logical collection (live ``(id, vector-as-stored)`` pairs in
    ascending-id order) with the index's recorded seed/levels/cap/metric
    — because the rebuild IS that build, fed from a disk spool of the live
    rows.

    fstore: nodes are rewritten in place through the Store protocol by the
    streaming build, with O(chunk + leaders) peak memory, and stale nodes
    freed (not crash-atomic; saved query states are cleared).
    blob: the one-shot build over the spool (memory: its insert batch, one
    leaf and O(live items) integers) writes a scratch hierarchy, which is
    converted and atomically swapped over the blob file (readers holding
    the old fd keep the old view until they reopen).
    """
    info = index.info
    store = index.store
    drain = getattr(store, "drain", None)
    if drain is not None:
        drain()
    L = info.levels
    dt = np.dtype(info.dtype)
    tombs = index.tombstones
    tomb_arr = (
        np.fromiter(tombs, np.int64, len(tombs)) if tombs else np.empty(0, np.int64)
    )
    n_leaf = info.nodes_per_level[-1]
    old_npl = list(info.nodes_per_level)

    with tempfile.TemporaryDirectory(prefix="ecpfs_compact_") as td:
        # ---- spool live leaf rows (storage dtype) + collect their ids
        raw = Path(td) / "live.rows"
        all_ids: list[np.ndarray] = []
        n_live = 0
        n_scanned = 0
        with open(raw, "wb") as f:
            batch = 64
            for lo in range(0, n_leaf, batch):
                keys = [(L, j) for j in range(lo, min(lo + batch, n_leaf))]
                for emb, nids in store.get_nodes(keys):
                    if len(nids) == 0:
                        continue
                    n_scanned += len(nids)
                    nids = np.asarray(nids, np.int64)
                    if len(tomb_arr):
                        keep = ~np.isin(nids, tomb_arr)
                        emb, nids = emb[keep], nids[keep]
                    if len(nids) == 0:
                        continue
                    np.ascontiguousarray(emb, dtype=dt).tofile(f)
                    all_ids.append(nids)
                    n_live += len(nids)
        if n_live == 0:
            raise ValueError(
                "compact() would produce an empty index (every item is "
                "tombstoned); delete the index instead"
            )
        ids_flat = np.concatenate(all_ids)
        order = np.argsort(ids_flat, kind="stable")
        sorted_ids = ids_flat[order]
        if len(sorted_ids) > 1 and (sorted_ids[1:] == sorted_ids[:-1]).any():
            if info.spill_s <= 0:
                raise RuntimeError("duplicate item ids in the index; cannot compact")
            # spill-built index: replicas of one id are expected; keep the
            # first physical occurrence (they are bitwise-identical rows).
            # The rebuild below re-derives fresh replicas from spill_s.
            keep = np.r_[True, sorted_ids[1:] != sorted_ids[:-1]]
            order = order[keep]
            sorted_ids = sorted_ids[keep]
        n_logical = len(sorted_ids)
        mm = np.memmap(raw, dtype=dt, mode="r", shape=(n_live, info.dim))

        def canonical_chunks():
            # live items in ascending-id order, O(chunk) resident
            for lo in range(0, n_logical, 8192):
                sel = order[lo : lo + 8192]
                yield np.asarray(mm[sel], np.float32), sorted_ids[lo : lo + 8192]

        cfg = ECPBuildConfig(
            levels=L,
            metric=info.metric,
            cluster_cap=info.cluster_cap,
            storage_dtype=info.dtype,
            seed=info.seed,
            insert_batch=info.insert_batch,  # replay the build's exact
            # assignment batching: device argmin results must not shift
            spill_s=info.spill_s,
            spill_eps=info.spill_eps,
        )
        gen = info.generation + 1
        if getattr(store, "fstore", None) is not None:
            # ---- in place through the Store protocol
            build_index_streaming(canonical_chunks, cfg=cfg, store=store,
                                  generation=gen, next_id=info.next_id, device=index.device)
            new_info = layout.IndexInfo.from_attrs(store.read_attrs(layout.INFO))
            for lv in range(1, L + 1):
                for nd in range(new_info.nodes_per_level[lv - 1], old_npl[lv - 1]):
                    store.free_slot(lv, nd)
            # saved query states reference the old node numbering
            if store.exists("query_states"):
                store.delete("query_states")
        else:
            # ---- blob: rebuild a scratch hierarchy, convert, atomic swap
            blob_path = Path(store.path)
            if not index._owns_store:
                raise ValueError(
                    "blob compaction replaces the file and must reopen it; "
                    "open the index from a path (not a Store object) to compact"
                )
            # the scratch hierarchy is only converted, so its file layout is
            # free: the one-shot build over the live rows in id order writes
            # each leaf once, where the streaming build appends to every leaf
            # in every insert batch (the same nodes and attributes, so the
            # same blob)
            canon = Path(td) / "canonical.rows"
            with open(canon, "wb") as f:
                for lo in range(0, n_logical, 8192):
                    np.ascontiguousarray(mm[order[lo : lo + 8192]]).tofile(f)
            rows = np.memmap(canon, dtype=dt, mode="r", shape=(n_logical, info.dim))
            tmp_store = _build_one_shot(rows, str(Path(td) / "rebuild"), cfg, item_ids=sorted_ids,
                                        device=index.device, generation=gen, next_id=info.next_id)
            del rows
            page = getattr(store, "page_size", 4096)
            with tempfile.TemporaryDirectory(dir=blob_path.parent) as swap_td:
                tmp_blob = convert(tmp_store, Path(swap_td) / BLOB_FILENAME, page_size=page,
                                   quant=getattr(store, "quant_format", None))
                os.replace(tmp_blob, blob_path)
            new_info = layout.IndexInfo.from_attrs(tmp_store.read_attrs(layout.INFO))
            index._reload_store()

    index._apply_mutation(new_info, (), tombstones=set(), structural=True)
    return {
        "live": n_logical,
        "purged": n_scanned - n_live,
        "leaves": new_info.nodes_per_level[-1],
        "generation": new_info.generation,
    }
