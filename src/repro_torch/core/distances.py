"""Distance computations shared by build and search.

All metrics are *distances*: smaller is better.
  l2      : squared euclidean  ||q - c||^2
  ip      : negative inner product  -<q, c>
  cosine  : 1 - cos(q, c)

``np_distances`` is the host path (traversal, rerank) and is a verbatim copy
of the JAX package's, so host results stay bit-identical across the two
packages.  ``torch_distances`` is the tensor counterpart of its
``jnp_distances`` (the build's leaf assignment runs it on the device).
"""
from __future__ import annotations

import numpy as np
import torch

METRICS = ("l2", "ip", "cosine")


def _check(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; one of {METRICS}")


# ------------------------------------------------------------------ numpy
def np_distances(
    q: np.ndarray, c: np.ndarray, metric: str, *, c_sqnorms: np.ndarray | None = None
) -> np.ndarray:
    """q: [B, D] or [D]; c: [N, D] -> [B, N] or [N] float32 distances.

    ``c_sqnorms`` optionally supplies precomputed ``(c * c).sum(-1)`` for
    the l2 and cosine metrics (per-node norm caching in the search
    engine).  It MUST equal that exact expression over the float32 ``c``
    — then results are bit-identical to the uncached path (for cosine,
    ``np.sqrt`` of the reduction is bitwise what ``np.linalg.norm``
    computes).  Ignored for ip.
    """
    _check(metric)
    q = np.asarray(q, np.float32)
    c = np.asarray(c, np.float32)
    squeeze = q.ndim == 1
    if squeeze:
        q = q[None]
    if metric == "ip":
        d = -(q @ c.T)
    elif metric == "l2":
        qn = (q * q).sum(-1, keepdims=True)
        cn = ((c * c).sum(-1) if c_sqnorms is None else np.asarray(c_sqnorms, np.float32))[None, :]
        d = qn + cn - 2.0 * (q @ c.T)
    else:  # cosine
        qn = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
        if c_sqnorms is None:
            c_norm = np.linalg.norm(c, axis=-1)
        else:
            c_norm = np.sqrt(np.asarray(c_sqnorms, np.float32))
        cn = c / np.maximum(c_norm[:, None], 1e-12)
        d = 1.0 - qn @ cn.T
    return d[0] if squeeze else d


# ------------------------------------------------------------------ torch
def torch_distances(q: torch.Tensor, c: torch.Tensor, metric: str) -> torch.Tensor:
    """q: [..., B, D]; c: [..., N, D] -> [..., B, N] distances (f32 accum)."""
    _check(metric)
    q = q.to(torch.float32)
    c = c.to(torch.float32)
    if metric == "ip":
        return -torch.einsum("...bd,...nd->...bn", q, c)
    if metric == "l2":
        qn = torch.sum(q * q, dim=-1)[..., :, None]
        cn = torch.sum(c * c, dim=-1)[..., None, :]
        return qn + cn - 2.0 * torch.einsum("...bd,...nd->...bn", q, c)
    qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    cn = c / torch.clamp(torch.linalg.vector_norm(c, dim=-1, keepdim=True), min=1e-12)
    return 1.0 - torch.einsum("...bd,...nd->...bn", qn, cn)
