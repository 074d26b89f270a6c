"""Synthetic data generators, deterministic in their seed (the port's copy
of the reference's ``data/synthetic.py``, on the same numpy streams in the
same draw order, so that both packages get bit-identical data).

Every batch is a pure function of (seed, step, shard), never of iteration
history: a restart from a checkpoint replays the exact token and example
stream (the fault-tolerance contract in ``distributed/fault_tolerance.py``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["lm_batch", "ctr_batch", "clustered_vectors", "random_graph", "batched_molecules"]


def _rng(seed: int, step: int, shard: int = 0):
    return np.random.default_rng(np.random.SeedSequence([seed, step, shard]))


def lm_batch(seed: int, step: int, *, batch: int, seq: int, vocab: int, shard: int = 0):
    r = _rng(seed, step, shard)
    return {"tokens": r.integers(0, vocab, size=(batch, seq), dtype=np.int32)}


def ctr_batch(
    seed: int,
    step: int,
    *,
    batch: int,
    field_vocabs: tuple,
    n_dense: int = 0,
    seq_len: int = 0,
    seq_fields: int = 0,
    shard: int = 0,
):
    """One CTR batch (numpy), a pure function of (seed, step, shard): raw
    per-field ids "cat" [batch, n_fields - seq_fields], "label" [batch];
    "dense" [batch, n_dense] when n_dense; "seq" [batch, seq_len,
    seq_fields], "seq_mask" (a random length of at least 1) and "target"
    [batch, seq_fields] when seq_len."""
    r = _rng(seed, step, shard)
    n_plain = len(field_vocabs) - seq_fields
    out = {
        "cat": np.stack(
            [r.integers(0, v, size=batch) for v in field_vocabs[seq_fields:]], axis=1
        ).astype(np.int32)
        if n_plain
        else np.zeros((batch, 0), np.int32),
        "label": r.integers(0, 2, size=batch).astype(np.float32),
    }
    if n_dense:
        out["dense"] = r.normal(size=(batch, n_dense)).astype(np.float32)
    if seq_len:
        out["seq"] = np.stack(
            [r.integers(0, field_vocabs[f], size=(batch, seq_len)) for f in range(seq_fields)],
            axis=2,
        ).astype(np.int32)
        lens = r.integers(1, seq_len + 1, size=batch)
        out["seq_mask"] = (np.arange(seq_len)[None, :] < lens[:, None]).astype(np.float32)
        out["target"] = np.stack(
            [r.integers(0, field_vocabs[f], size=batch) for f in range(seq_fields)], axis=1
        ).astype(np.int32)
    return out


def clustered_vectors(
    seed: int, *, n: int, dim: int, n_clusters: int = 64, spread: float = 0.15
):
    """Mixture-of-Gaussians embeddings — realistic ANN benchmark data
    (isotropic Gaussian is the degenerate worst case; real CLIP/SigLIP
    embeddings cluster, which is the regime eCP exploits)."""
    r = np.random.default_rng(seed)
    centers = r.normal(size=(n_clusters, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    which = r.integers(0, n_clusters, size=n)
    x = centers[which] + spread * r.normal(size=(n, dim)).astype(np.float32)
    return x.astype(np.float32), which


def random_graph(seed: int, *, n_nodes: int, n_edges: int, d_feat: int, n_classes: int):
    r = np.random.default_rng(seed)
    src = r.integers(0, n_nodes, size=n_edges).astype(np.int32)
    dst = r.integers(0, n_nodes, size=n_edges).astype(np.int32)
    feats = r.normal(size=(n_nodes, d_feat)).astype(np.float32)
    labels = r.integers(0, n_classes, size=n_nodes).astype(np.int32)
    return {"feats": feats, "edge_src": src, "edge_dst": dst, "labels": labels}


def batched_molecules(
    seed: int, step: int, *, batch: int, n_nodes: int, n_edges: int, d_feat: int, n_classes: int
):
    r = _rng(seed, step)
    return {
        "feats": r.normal(size=(batch, n_nodes, d_feat)).astype(np.float32),
        "edge_src": r.integers(0, n_nodes, size=(batch, n_edges)).astype(np.int32),
        "edge_dst": r.integers(0, n_nodes, size=(batch, n_edges)).astype(np.int32),
        "node_mask": (
            np.arange(n_nodes)[None, :] < r.integers(n_nodes // 2, n_nodes + 1, size=(batch, 1))
        ).astype(np.float32),
        "labels": r.integers(0, n_classes, size=batch).astype(np.int32),
    }
