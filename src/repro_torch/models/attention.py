"""Attention dispatch for the LM family.

Three implementations, one math:
  * ``full``    — plain einsum softmax attention (``mha_ref``; tiny configs);
  * ``chunked`` — a loop over query blocks, each an exact softmax over the
                  whole kv with the reference's masking and guards; plain
                  torch, differentiable, the decode and the training path;
                  with ``remat`` and grad enabled each block runs under
                  ``torch.utils.checkpoint``, so the backward pass
                  recomputes its [B, Hq, cq, Skv] scores instead of saving
                  them (the reference's ``jax.checkpoint`` on its body);
  * ``flash``   — the hand-written Hopper kernel
                  (``kernels/flash_attention``), the prefill path.

All are GQA-aware ([B, Hq, Sq, d] queries vs [B, Hkv, Skv, d] kv) and
return float32.  ``flash_decode_sharded`` (the reference's decode over a
sequence-sharded cache) waits for ROADMAP Queue 1 #13.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import mha_ref
from ..kernels.flash_attention import ops as flash_ops

__all__ = ["attention"]


def _block(qb, ke32, ve32, vdtype, kv_idx, end, j0, *, causal, scale, Sq):
    """One query block's exact attention [B, Hq, n, d] in float32: scores in
    float32 from the storage dtype (``ke32``, ``ve32``: exact casts; a bf16
    x bf16 product is exact in float32, as preferred_element_type=f32),
    masked, a softmax guarded for rows with no live key, the probabilities
    cast to the storage dtype ``vdtype`` before the product with v."""
    n = qb.shape[2]
    s = torch.matmul(qb.to(torch.float32), ke32.transpose(-1, -2)) * scale   # [B,Hq,n,Skv] f32
    mask = (kv_idx[None, None, :] < end[:, None, :])             # [B,1,Skv]
    if causal:
        q_idx = j0 + torch.arange(n, device=qb.device)
        mask = mask & (kv_idx[None, None, :] <= (q_idx[None, :, None] + (end[:, :, None] - Sq)))
    mask = mask[:, None]
    s = torch.where(mask, s, -torch.inf)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    del s
    p = torch.where(mask, p, 0.0)
    denom = torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    pb = (p / denom).to(vdtype).to(torch.float32)
    del p
    return torch.matmul(pb, ve32)


def _chunked(q, k, v, *, causal, scale, chunk, kv_lens=None, remat=True):
    """Exact attention over query blocks of ``chunk`` rows, as the reference's
    ``_chunked``.  The reference pads the last block; here it is shorter,
    which gives the same rows.  Under grad with ``remat``, each block is a
    ``torch.utils.checkpoint`` region that saves only its inputs; without
    grad the blocks run as they are."""
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    cq = min(chunk, Sq)
    # GQA expansion in the storage dtype, then exact float32 copies
    ke = (torch.repeat_interleave(k, group, dim=1) if group > 1 else k).to(torch.float32)
    ve = torch.repeat_interleave(v, group, dim=1) if group > 1 else v
    ve32 = ve.to(torch.float32)
    kv_idx = torch.arange(Skv, device=q.device)
    end = (
        kv_lens.to(device=q.device, dtype=torch.int64)[:, None]
        if kv_lens is not None
        else torch.full((B, 1), Skv, dtype=torch.int64, device=q.device)
    )
    ckpt = remat and torch.is_grad_enabled()
    out = torch.empty((B, Hq, Sq, d), dtype=torch.float32, device=q.device)
    for j0 in range(0, Sq, cq):
        args = (q[:, :, j0 : j0 + cq], ke, ve32, ve.dtype, kv_idx, end, j0)
        kw = dict(causal=causal, scale=scale, Sq=Sq)
        out[:, :, j0 : j0 + cq] = (checkpoint(_block, *args, **kw, use_reentrant=False) if ckpt
                                   else _block(*args, **kw))
    return out


def attention(q, k, v, *, causal: bool = True, kv_lens=None, scale: float | None = None,
              impl: str = "chunked", chunk: int = 1024, remat: bool = True):
    """Unified attention. Returns [B, Hq, Sq, d] in float32."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    if impl == "full":
        return mha_ref(q, k, v, causal=causal, kv_lens=kv_lens, scale=scale)
    if impl == "chunked":
        return _chunked(q, k, v, causal=causal, scale=scale, chunk=chunk, kv_lens=kv_lens, remat=remat)
    if impl == "flash":
        return flash_ops.flash_attention(q, k, v, kv_lens=kv_lens, causal=causal, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r} (full|chunked|flash)")
