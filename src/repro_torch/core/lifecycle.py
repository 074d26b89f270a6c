"""Index construction: the one-shot build of the eCP-FS file structure.

The port's counterpart of the reference's ``core/lifecycle.py``, for the
one-shot build (paper §3): leaders sampled uniformly at random, nested-
prefix upper levels, top-down beam-1 insertion, written to the file
structure.  Leader sampling, spill and the writes are numpy and match the
reference byte for byte; the leaf assignment (``_assign_level`` and the
batched beam-1 descent of ``_make_insert_fn``) runs as PyTorch on
``device``, in batches of ``cfg.insert_batch`` rows.

Not ported yet (ROADMAP Queue 1 #5): the streaming build
(``build_index_streaming``, ``reservoir_sample``), ``insert_items``,
``delete_items`` and ``compact``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from . import layout
from .distances import np_distances, torch_distances
from .packed import PackedLevel, pack_children
from .store import FStoreBackend, open_store

__all__ = ["ECPBuildConfig", "build_index"]


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
        insert_batch=cfg.insert_batch,
        next_id=int(item_ids.max()) + 1,
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
