"""eCP retrieval attention: the paper's index running inside the model.

The reference's ``repro.models.retrieval_attention`` on one device.  For
long-context decode the KV cache is organised as an eCP leaf level:
clusters of ``cs`` consecutive tokens, each with a centroid (the running
mean of its keys).  A decode step scores the query against every centroid
(mean over the query group), keeps the top-b complete clusters per kv head
plus the current, partial one, and runs exact attention over the valid
tokens of those clusters: at 524288 tokens, cs = 512 and b = 32, 1024
centroid scores and 33 x 512 token scores a head instead of 524288.

The cache is written in place (``clustered_cache_update``), as the port's
``transformer.decode_step`` writes its cache: the reference returns a new
cache each step, and a copy of a 64 GiB cache a step cannot exist on the
card.  The decode step itself reaches no kernel in the reference (einsum
and ``jax.lax.top_k``) and none here.

Sequence parallelism (``retrieval_decode_attention_sharded``,
``retrieval_update_and_attend_sharded``): the cache's cluster axis is
sharded over a mesh's ``seq_axes`` and the clusters never move.  Each
rank scores its centroids, an all-gather of the ranks' local top-b scores
gives the global b-th best as the selection threshold, each rank attends
over its selected clusters, and a flash-style (m, l, acc) combine joins
the ranks.  The fused variant first writes the new token into the shard
that owns its cluster, in place.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..distributed import collectives as C
from ..launch.mesh import axis_index, axis_size

__all__ = [
    "ClusteredKVCache", "RetrievalAttnConfig", "init_clustered_cache", "clustered_cache_update",
    "retrieval_decode_attention", "retrieval_update_and_attend_sharded", "retrieval_decode_attention_sharded",
]


@dataclass(frozen=True)
class RetrievalAttnConfig:
    cluster_size: int = 512     # cs: tokens per KV cluster (eCP cluster cap)
    top_clusters: int = 32      # b: search expansion


@dataclass
class ClusteredKVCache:
    k: torch.Tensor          # [L, B, Hkv, nC, cs, d] in cfg.dtype
    v: torch.Tensor          # [L, B, Hkv, nC, cs, d]
    centroids: torch.Tensor  # [L, B, Hkv, nC, d] float32, running mean of keys
    pos: int                 # tokens written so far


def init_clustered_cache(n_layers, batch, n_kv, max_seq, cs, d, dtype=torch.bfloat16, *, device="cuda"):
    nC = -(-max_seq // cs)
    dev = resolve_device(device)
    shape = (n_layers, batch, n_kv, nC, cs, d)
    return ClusteredKVCache(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        centroids=torch.zeros(shape[:4] + (d,), dtype=torch.float32, device=dev),
        pos=0,
    )


def clustered_cache_update(layer_k, layer_v, layer_cent, k_new, v_new, pos: int, cs: int):
    """Write one token's k/v into its cluster and update that cluster's
    centroid, in place.

    layer_k/v [B, Hkv, nC, cs, d]; layer_cent [B, Hkv, nC, d];
    k_new/v_new [B, Hkv, d].  The centroid is ``old + (k - old) / n`` in
    float32, the reference's order of operations.
    """
    cid, off = divmod(pos, cs)
    layer_k[:, :, cid, off] = k_new.to(layer_k.dtype)
    layer_v[:, :, cid, off] = v_new.to(layer_v.dtype)
    old_c = layer_cent[:, :, cid]
    # a tensor divisor on the centroids' device: CUDA turns division by a
    # host scalar into a product with its reciprocal, another rounding
    n = torch.full((), off + 1, dtype=torch.float32, device=layer_cent.device)
    layer_cent[:, :, cid] = old_c + (k_new.to(torch.float32) - old_c) / n


def retrieval_decode_attention(q, layer_k, layer_v, layer_cent, pos: int, *, cs: int, top_b: int,
                               scale: float | None = None):
    """One decode step of eCP retrieval attention.

    q [B, Hq, d] (single token); layer_k/v [B, Hkv, nC, cs, d];
    layer_cent [B, Hkv, nC, d]; pos: tokens cached, INCLUDING the current
    token already written.  Returns [B, Hq, d] float32.
    """
    B, Hq, d = q.shape
    Hkv, nC = layer_k.shape[1], layer_k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (d**0.5)
    dev = q.device
    qg = (q.to(torch.float32) * scale).reshape(B, Hkv, group, d)

    # 1) index traversal: inner product with every centroid, mean over the
    #    query group; only complete clusters may be chosen
    cur = (pos - 1) // cs
    cent_scores = torch.einsum("bhgd,bhnd->bhgn", qg, layer_cent).mean(2)      # [B, Hkv, nC]
    cent_scores = torch.where(torch.arange(nC, device=dev) < cur, cent_scores, -torch.inf)

    # 2) search expansion: the top-b complete clusters and the current one.
    #    Slots whose score is -inf (fewer than b complete clusters) hold any
    #    index: the isfinite mask below removes them.
    b = min(top_b, nC)
    top_s, top_idx = torch.topk(cent_scores, b, dim=-1)                         # [B, Hkv, b]
    sel = torch.cat([top_idx, torch.full((B, Hkv, 1), cur, dtype=top_idx.dtype, device=dev)], dim=-1)
    sel_s = torch.cat([top_s, torch.zeros((B, Hkv, 1), device=dev)], dim=-1)    # the current one's is 0

    # 3) gather and exact attention over the selected clusters' valid tokens
    bi = torch.arange(B, device=dev)[:, None, None]
    hi = torch.arange(Hkv, device=dev)[None, :, None]
    ks = layer_k[bi, hi, sel].to(torch.float32)                                 # [B, Hkv, b+1, cs, d]
    vs = layer_v[bi, hi, sel].to(torch.float32)
    tok_idx = sel[..., None] * cs + torch.arange(cs, device=dev)                # [B, Hkv, b+1, cs]
    valid = (tok_idx < pos) & (sel[..., None] >= 0) & torch.isfinite(sel_s)[..., None]
    s = torch.einsum("bhgd,bhncd->bhgnc", qg, ks)                               # [B, Hkv, g, b+1, cs]
    s = torch.where(valid[:, :, None], s, -torch.inf)
    sf = s.reshape(B, Hkv, group, -1)
    m = torch.amax(sf, dim=-1, keepdim=True)
    p = torch.exp(sf - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    p = torch.where(torch.isfinite(sf), p, 0.0)
    denom = torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    p = (p / denom).reshape(B, Hkv, group, b + 1, cs)
    out = torch.einsum("bhgnc,bhncd->bhgd", p, vs)
    return out.reshape(B, Hq, d)


def _offset(mesh, seq_axes, nC_loc: int) -> int:
    """The first global cluster of this rank's shard: ``off = off * size(a)
    + index(a)`` over ``seq_axes`` in order, times the shard's clusters."""
    return axis_index(mesh, seq_axes) * nC_loc


def retrieval_update_and_attend_sharded(q, layer_k, layer_v, layer_cent, k_new, v_new, pos: int, *, cs: int,
                                        top_b: int, mesh, seq_axes: tuple, scale: float | None = None):
    """The fused sharded cache write and retrieval attention.

    layer_k/v [B, Hkv, nC_loc, cs, d], layer_cent [B, Hkv, nC_loc, d]: this
    rank's clusters (the cluster axis split evenly over ``seq_axes``);
    q [B, Hq, d], k_new/v_new [B, Hkv, d] replicated.  Only the rank that
    owns the cluster of ``pos`` writes the token and its centroid, in
    place; then attention at ``pos + 1``.  Returns (out [B, Hq, d] float32,
    layer_k, layer_v, layer_cent), the caches the tensors passed in.
    """
    nC_loc = layer_k.shape[2]
    off = _offset(mesh, seq_axes, nC_loc)
    cid, tok_off = divmod(pos, cs)
    if off <= cid < off + nC_loc:
        clustered_cache_update(layer_k, layer_v, layer_cent, k_new, v_new, (cid - off) * cs + tok_off, cs)
    out = _local_retrieval_attend(q, layer_k, layer_v, layer_cent, pos + 1, off=off, cs=cs, top_b=top_b,
                                  mesh=mesh, seq_axes=seq_axes, scale=scale)
    return out, layer_k, layer_v, layer_cent


def _local_retrieval_attend(qb, kb, vb, cb, posb: int, *, off: int, cs: int, top_b: int, mesh, seq_axes,
                            scale: float | None = None):
    """A rank's part of sharded retrieval attention: score the local
    centroids, select against the global b-th best complete cluster's
    score, attend over the selected local clusters (and the current one,
    where local), combine (m, l, acc) over ``seq_axes``."""
    B, Hq, d = qb.shape
    Hkv, nC_loc = kb.shape[1], kb.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (d**0.5)
    dev = qb.device
    qg = (qb.to(torch.float32) * scale).reshape(B, Hkv, group, d)
    cent_s = torch.einsum("bhgd,bhnd->bhgn", qg, cb).mean(2)                     # [B, Hkv, nC_loc]
    cur = (posb - 1) // cs
    gidx = off + torch.arange(nC_loc, device=dev)
    full = gidx[None, None, :] < cur
    cent_m = torch.where(full, cent_s, -torch.inf)
    b_loc = min(top_b, nC_loc)
    loc_top = torch.topk(cent_m, b_loc, dim=-1).values                         # [B, Hkv, b_loc]
    n_sh = axis_size(mesh, seq_axes)
    allc = C.gather(loc_top[None], mesh, seq_axes, 0, n_sh)                    # [n_sh, B, Hkv, b_loc]
    flat = allc.permute(1, 2, 0, 3).reshape(B, Hkv, -1)
    kk = min(top_b, flat.shape[-1])
    kth = torch.topk(flat, kk, dim=-1).values[..., -1]
    sel = ((cent_m >= kth[..., None]) & full) | (gidx[None, None, :] == cur)   # [B, Hkv, nC_loc]
    s = torch.einsum("bhgd,bhncd->bhgnc", qg.to(kb.dtype).to(torch.float32), kb.to(torch.float32))
    tok = gidx[:, None] * cs + torch.arange(cs, device=dev)[None, :]
    valid = sel[:, :, None, :, None] & (tok < posb)[None, None, None]
    s = torch.where(valid, s, -torch.inf)
    sf = s.reshape(B, Hkv, group, -1)
    m_loc = torch.amax(sf, dim=-1, keepdim=True)
    zero = torch.zeros((), device=dev)
    safe = torch.where(torch.isfinite(m_loc), m_loc, zero)
    p = torch.where(torch.isfinite(sf), torch.exp(sf - safe), zero)
    l_loc = torch.sum(p, dim=-1, keepdim=True)
    acc_loc = torch.einsum("bhgnc,bhncd->bhgd", p.reshape(B, Hkv, group, nC_loc, cs).to(vb.dtype).to(torch.float32),
                           vb.to(torch.float32))
    m_g = C.all_reduce(m_loc, mesh, seq_axes, op="max")
    corr = torch.where(torch.isfinite(m_loc), torch.exp(m_loc - torch.where(torch.isfinite(m_g), m_g, zero)), zero)
    l_g = C.all_reduce(l_loc * corr, mesh, seq_axes)
    acc_g = C.all_reduce(acc_loc * corr, mesh, seq_axes)
    out = acc_g / torch.clamp_min(l_g, 1e-30)
    return out.reshape(B, Hq, d)


def retrieval_decode_attention_sharded(q, layer_k, layer_v, layer_cent, pos: int, *, cs: int, top_b: int, mesh,
                                       seq_axes: tuple, scale: float | None = None):
    """Sequence-parallel eCP retrieval attention: the clusters never move.

    layer_k/v [B, Hkv, nC_loc, cs, d] and layer_cent [B, Hkv, nC_loc, d]:
    this rank's clusters (split evenly over ``seq_axes``); q [B, Hq, d]
    replicated; pos as ``retrieval_decode_attention``'s.  Each rank scores
    its centroids, contributes its local top-b scores to a small
    all-gather whose b-th best is the selection threshold (ties may admit a
    few clusters more), runs masked attention over its own clusters, and
    the partial softmaxes combine as flash decoding's: O(B·Hq·d) a layer
    crosses ranks.  Returns [B, Hq, d] float32.
    """
    off = _offset(mesh, seq_axes, layer_k.shape[2])
    return _local_retrieval_attend(q, layer_k, layer_v, layer_cent, pos, off=off, cs=cs, top_b=top_b, mesh=mesh,
                                   seq_axes=seq_axes, scale=scale)
