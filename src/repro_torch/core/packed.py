"""Packed (dense, device-friendly) view of one level of the index hierarchy.

The port's build needs only ``PackedLevel`` and ``pack_children``: each
internal level's ragged children lists packed into rectangular arrays

  emb  [n_nodes, max_children, D]  float32 (padding rows are zeros)
  ids  [n_nodes, max_children]     int32   (padded with -1)
  mask [n_nodes, max_children]     bool

for the batched beam-1 descent of the leaf assignment.  ``PackedIndex``,
``load_packed`` and the packed device search are not ported yet (ROADMAP
Queue 1 #6).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
