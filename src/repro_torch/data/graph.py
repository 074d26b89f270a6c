"""Host-side graph utilities: CSR adjacency + layered neighbor sampling
(a numpy copy of the reference's ``repro.data.graph``).

``minibatch_lg`` needs a real neighbor sampler: this one builds CSR once,
then per batch samples ``fanouts`` neighbors per hop and returns the dense
fanout feature tensors the model's sampled path consumes.
"""
from __future__ import annotations

import numpy as np

__all__ = ["CSRGraph", "sample_hops"]


class CSRGraph:
    def __init__(self, n_nodes: int, edge_src: np.ndarray, edge_dst: np.ndarray):
        self.n = n_nodes
        order = np.argsort(edge_dst, kind="stable")
        self.nbr = edge_src[order].astype(np.int64)
        counts = np.bincount(edge_dst, minlength=n_nodes)
        self.ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    def degree(self, v: int) -> int:
        return int(self.ptr[v + 1] - self.ptr[v])

    def neighbors(self, v: int) -> np.ndarray:
        return self.nbr[self.ptr[v] : self.ptr[v + 1]]


def _sample_neighbors(g: CSRGraph, nodes: np.ndarray, fanout: int, rng) -> np.ndarray:
    """[M] node ids -> [M, fanout] sampled in-neighbors (self-loop padded)."""
    starts = g.ptr[nodes]
    degs = g.ptr[nodes + 1] - starts
    r = rng.random((len(nodes), fanout))
    has = degs > 0
    idx = (r * np.maximum(degs, 1)[:, None]).astype(np.int64)
    out = g.nbr[np.minimum(starts[:, None] + idx, len(g.nbr) - 1)]
    out[~has] = nodes[~has, None]  # isolated nodes: self loop
    return out


def sample_hops(
    g: CSRGraph,
    feats: np.ndarray,
    seeds: np.ndarray,
    fanouts: tuple,
    rng: np.random.Generator,
):
    """Returns fanout feature tensors, outermost hop first:
    [B, f1, ..., fL, d], ..., [B, f1, d], [B, d]."""
    frontiers = [seeds.astype(np.int64)]
    for f in fanouts:
        flat = frontiers[-1].reshape(-1)
        nbrs = _sample_neighbors(g, flat, f, rng)
        frontiers.append(nbrs.reshape(frontiers[-1].shape + (f,)))
    return tuple(feats[idx] for idx in reversed(frontiers))
