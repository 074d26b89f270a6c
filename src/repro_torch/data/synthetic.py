"""Synthetic data generators, deterministic in their seed (the port's copies
of the reference's ``data/synthetic.py``: ``clustered_vectors``, the ANN
benchmark data, and ``ctr_batch``, the recsys batches, on the same numpy
streams, so that both packages get bit-identical data)."""
from __future__ import annotations

import numpy as np

__all__ = ["clustered_vectors", "ctr_batch"]


def _rng(seed: int, step: int, shard: int = 0):
    return np.random.default_rng(np.random.SeedSequence([seed, step, shard]))


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
