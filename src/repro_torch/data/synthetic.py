"""Synthetic data generators, deterministic in their seed (the port's copy of
``clustered_vectors``, the ANN benchmark data of the reference's
``data/synthetic.py``)."""
from __future__ import annotations

import numpy as np

__all__ = ["clustered_vectors"]


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
