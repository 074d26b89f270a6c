"""Plain PyTorch version of packed mode's merge.

The chunk's distances are masked past each valid slot's real rows and in
the slots left out (``+inf``, id -1), appended to the buffer, and a stable
sort keeps the best C: ``BatchedSearcher._scan_chunk``'s merge as it was
before the op existed.  The wrapper in ``ops.py`` runs it for tensors on
the CPU; the card's tests hold the kernel against it.
"""
from __future__ import annotations

import torch


def ascending_top_k(d: torch.Tensor, ids: torch.Tensor, k: int):
    """Smallest-k by distance, ascending; equal distances keep index order
    (a stable sort), as ``jax.lax.top_k`` on ``-d`` does."""
    order = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    return torch.gather(d, -1, order), torch.gather(ids, -1, order)


def leaf_merge_ref(buf_d, buf_i, d, leaf_ids, n_rows, leaf_c, lvalid):
    """``ops.leaf_merge``'s function: the C smallest of the buffer ``buf_d``
    [B, C] (ids ``buf_i``) and the real rows of the valid slots of ``d``
    [B, b, cap] (ids from ``leaf_ids`` [L, cap]), ascending, equal distances
    in the order of the concatenation -> (buf_d, buf_i) [B, C]."""
    B, b, cap = d.shape
    rows = torch.arange(cap, device=d.device) < n_rows[leaf_c][..., None]   # [B, b, cap]
    mask = (rows & lvalid[..., None]).reshape(B, -1)
    d = torch.where(mask, d.reshape(B, -1), torch.inf)
    i = torch.where(mask, leaf_ids[leaf_c].reshape(B, -1), -1)
    C = buf_d.shape[1]
    return ascending_top_k(torch.cat([buf_d, d], dim=-1), torch.cat([buf_i, i], dim=-1), C)
