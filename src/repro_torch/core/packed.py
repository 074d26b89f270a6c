"""Packed (dense, device-friendly) view of the index hierarchy.

The file structure is the source of truth; for the batched device search
(core/batched.py) and the build's beam-1 descent each level's children
lists are packed into rectangular arrays

  emb  [n_nodes, max_children, D]  float32 (padding rows are zeros)
  ids  [n_nodes, max_children]     int32   (padded with -1)
  mask [n_nodes, max_children]     bool

Internal-level ids are child node indices at the next level; leaf-level
ids are item ids.  Search code masks padding to +inf before any top-k.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import layout
from .fstore import FStore
from .store import FStoreBackend, Store, open_store


@dataclass
class PackedLevel:
    emb: np.ndarray   # [n_nodes, max_children, D] float32
    ids: np.ndarray   # [n_nodes, max_children] int32
    mask: np.ndarray  # [n_nodes, max_children] bool

    @property
    def n_nodes(self) -> int:
        return self.emb.shape[0]

    @property
    def max_children(self) -> int:
        return self.emb.shape[1]


def pack_children(
    emb_lists: list[np.ndarray],
    id_lists: list[np.ndarray],
    dim: int,
    *,
    pad_multiple: int = 8,
) -> PackedLevel:
    """Pack per-node ragged children into a PackedLevel."""
    n_nodes = len(emb_lists)
    max_c = max((len(x) for x in id_lists), default=1)
    max_c = max(1, -(-max_c // pad_multiple) * pad_multiple)
    emb = np.zeros((n_nodes, max_c, dim), np.float32)
    ids = np.full((n_nodes, max_c), -1, np.int32)
    mask = np.zeros((n_nodes, max_c), bool)
    for j, (e, i) in enumerate(zip(emb_lists, id_lists)):
        n = len(i)
        if n:
            emb[j, :n] = np.asarray(e, np.float32)
            ids[j, :n] = np.asarray(i, np.int32)
            mask[j, :n] = True
    return PackedLevel(emb, ids, mask)


@dataclass
class PackedIndex:
    """Root centroids + one PackedLevel per lvl_1..lvl_L."""

    info: "layout.IndexInfo"
    root_emb: np.ndarray            # [n_1, D] float32
    levels: list[PackedLevel]       # levels[i] = children of lvl_{i+1} nodes

    @property
    def leaf(self) -> PackedLevel:
        return self.levels[-1]


def load_packed(store, *, max_leaf_pad: int = 8, batch: int = 256) -> PackedIndex:
    """Read a whole index into a PackedIndex (for device search).

    ``store`` is any ``Store`` backend (fstore hierarchy or blob file), a
    raw ``FStore``, or a path — node data comes through the protocol's
    batched ``get_nodes`` so e.g. the blob backend coalesces its reads.
    """
    if isinstance(store, FStore):
        store = FStoreBackend(store)
    elif not isinstance(store, Store):
        store = open_store(store)
    attrs = store.read_attrs(layout.INFO)
    info = layout.IndexInfo.from_attrs(attrs)
    if attrs.get(layout.DELETED_IDS):
        raise ValueError(
            "index holds tombstoned items, which the packed device search "
            "does not filter; run ECPIndex.compact() before load_packed()"
        )
    root_emb, _ = store.get_node(0, 0)
    levels = []
    for lv in range(1, info.levels + 1):
        keys = [(lv, j) for j in range(info.nodes_per_level[lv - 1])]
        emb_lists, id_lists = [], []
        for lo in range(0, len(keys), batch):
            for emb, ids in store.get_nodes(keys[lo : lo + batch]):
                emb_lists.append(emb)
                id_lists.append(ids)
        levels.append(pack_children(emb_lists, id_lists, info.dim, pad_multiple=max_leaf_pad))
    return PackedIndex(info=info, root_emb=root_emb, levels=levels)
