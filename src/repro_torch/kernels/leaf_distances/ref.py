"""Plain PyTorch version of packed mode's leaf scoring.

The distinct visited leaves (``torch.unique``) are scored against every
query in blocks of leaves sized to ``budget_bytes``, each leaf padded to
the largest (one float32 product a block, the reference's
``jnp_distances`` with the row-side terms precomputed), and each query's
own leaves are picked out of the products.  The wrapper in ``ops.py`` runs
it for tensors on the CPU; the card's tests hold the kernel against it.
"""
from __future__ import annotations

import torch

# bytes one block of leaves may take: its rows and its [B, rows] distances
SCAN_BUDGET_BYTES = 2 << 30


def prepared_distances(qp: torch.Tensor, q_sq, emb: torch.Tensor, sq, metric: str) -> torch.Tensor:
    """[B, D] prepared queries x [N, D] rows -> [B, N] distances: the
    reference's ``jnp_distances`` with the row-side terms precomputed
    (``q_sq``, ``sq``: squared norms, for l2 alone; cosine's sides come
    unit-normalised)."""
    dot = qp @ emb.T
    if metric == "ip":
        return -dot
    if metric == "l2":
        return q_sq[:, None] + sq[None, :] - 2.0 * dot
    return 1.0 - dot


def leaf_distances_ref(q, q_sq, emb, sq, n_rows, leaf_c, lvalid, metric: str,
                       budget_bytes: int = SCAN_BUDGET_BYTES) -> torch.Tensor:
    """``ops.leaf_distances``'s function: q [B, D] against the rows of the
    leaves ``leaf_c`` [B, b] of the block ``emb`` [L, cap, D] -> [B, b, cap].
    Past each leaf's ``n_rows`` it scores the zero padding, and in the
    slots ``lvalid`` leaves out the slot's leaf all the same: the caller
    masks both.  A block of leaves takes at most ``budget_bytes`` (its rows
    and its [B, rows] distances)."""
    B = q.shape[0]
    cap, D = emb.shape[1], emb.shape[2]
    u, inv = torch.unique(leaf_c, return_inverse=True)          # distinct visited leaves
    ub = max(1, budget_bytes // (cap * (D + B) * 4))
    rows_b = torch.arange(B, device=q.device)[:, None]
    out = None
    for lo in range(0, u.numel(), ub):
        blk = u[lo : lo + ub]
        blk_sq = None if sq is None else sq[blk].reshape(-1)
        d = prepared_distances(q, q_sq, emb[blk].reshape(-1, D), blk_sq, metric).view(B, -1, cap)
        if lo == 0 and blk.numel() == u.numel():
            out = d[rows_b, inv]
            break
        rel = torch.clamp(inv - lo, 0, blk.numel() - 1)
        part = d[rows_b, rel]
        inside = ((inv >= lo) & (inv < lo + blk.numel()))[..., None]
        out = part if out is None else torch.where(inside, part, out)
    return out
