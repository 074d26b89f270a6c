"""Decoder-only LM family on one device: dense GQA transformers and top-1 MoE variants.

The reference's model (``repro.models.transformer``) as plain functions over
a parameter dict: RoPE, SwiGLU, GQA, optional QKV bias, optional MoE FFN
(every layer, or alternating dense and MoE layers: ``moe_every=2``).  The
serving path is ``prefill`` (the prompt, attention by ``cfg.attn_impl``:
``"flash"`` runs the Hopper kernel in every layer) and then ``decode_step``
(one token, chunked attention over the cache, as the reference does on one
device), or ``retrieval_decode_step`` (one token, eCP retrieval attention
over a clustered cache: ``retrieval_attention.py``).

Parameters: ``{"embed": [V, D], "layers": [per-layer dict] * n_layers,
"final_norm": [D], "lm_head": [D, V]}``; the reference stacks the layers
as ``[L, ...]`` arrays (with ``moe_every=2`` as ``{"dense", "moe"}``
stacks of ``L / 2`` blocks) and scans them, the port keeps them apart and
loops, a block's dense layer before its MoE layer.  Every entry point
casts the weights to ``cfg.dtype`` where it uses them, inside the autograd
graph, as the reference's ``_cast_layers`` and per-use ``.astype`` do: a
layer's weights on entry to the layer, the embedding rows after the
lookup, ``final_norm`` and ``lm_head`` at their use.  Training holds
float32 master weights (``init_params(..., dtype=cfg.param_dtype)``);
serving holds them already in ``cfg.dtype`` (the default of
``init_params`` and ``base.params_from_jax``), where each cast is a no-op.

Training: ``lm_loss`` (next-token cross entropy plus the MoE aux loss)
through torch autograd; with ``cfg.remat`` each layer is a
``torch.utils.checkpoint`` region (the reference's ``jax.checkpoint`` on
its scan body), and chunked attention checkpoints its query blocks.

Not ported yet, raising ``NotImplementedError``: sharding rules (ROADMAP
Queue 1 #13).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .attention import attention
from .base import ParamSpec as P
from .base import init_params as _init_params
from .layers import rms_norm, rope, softmax_xent, swiglu
from .moe import MoEConfig, moe_ffn
from .retrieval_attention import (
    ClusteredKVCache,
    RetrievalAttnConfig,
    clustered_cache_update,
    retrieval_decode_attention,
)

__all__ = [
    "LMConfig", "ShardingRules", "KVCache", "param_specs", "decay_mask", "stacked_groups", "init_params",
    "forward", "lm_loss", "prefill", "decode_step", "retrieval_decode_step", "init_cache",
]


@dataclass(frozen=True)
class ShardingRules:
    """The reference's logical-axis -> mesh-axis mapping.  The port runs on
    one device: only the empty rules are accepted."""

    batch: tuple = ()
    model: str | None = None
    seq: str | None = None


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    max_seq: int = 4096
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    moe: MoEConfig | None = None
    moe_every: int = 1              # 2 => alternate dense/MoE layers (Llama-4)
    retrieval: RetrievalAttnConfig = field(default_factory=RetrievalAttnConfig)
    attn_impl: str = "chunked"      # full | chunked | flash
    attn_chunk: int = 1024
    remat: bool = True              # training: recompute each layer in the backward pass
    microbatches: int = 1           # gradient-accumulation chunks per step

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head


def _check(rules) -> None:
    if rules is not None and (rules.batch or rules.model is not None or rules.seq is not None):
        raise NotImplementedError("sharding rules are not ported yet: the port runs on one device (ROADMAP Queue 1 #13)")


# ------------------------------------------------------------------ params
def _layer_specs(cfg: LMConfig, *, moe: bool) -> dict:
    """Specs of one layer with a dense or an MoE FFN."""
    D, F = cfg.d_model, cfg.d_ff
    pdt = cfg.param_dtype
    layers: dict[str, P] = {
        "attn_norm": P((D,), pdt, "ones"),
        "wq": P((D, cfg.q_dim), pdt),
        "wk": P((D, cfg.kv_dim), pdt),
        "wv": P((D, cfg.kv_dim), pdt),
        "wo": P((cfg.q_dim, D), pdt),
        "ffn_norm": P((D,), pdt, "ones"),
    }
    if cfg.qkv_bias:
        layers["bq"] = P((cfg.q_dim,), pdt, "zeros")
        layers["bk"] = P((cfg.kv_dim,), pdt, "zeros")
        layers["bv"] = P((cfg.kv_dim,), pdt, "zeros")
    if not moe:
        layers["w_gate"] = P((D, F), pdt)
        layers["w_up"] = P((D, F), pdt)
        layers["w_down"] = P((F, D), pdt)
    else:
        E, Fe = cfg.moe.n_experts, cfg.moe.d_ff
        layers["router"] = P((D, E), pdt)
        layers["we_gate"] = P((E, D, Fe), pdt)
        layers["we_up"] = P((E, D, Fe), pdt)
        layers["we_down"] = P((E, Fe, D), pdt)
    return layers


def _is_block(cfg: LMConfig) -> bool:
    return cfg.moe is not None and cfg.moe_every == 2


def _moe_layers(cfg: LMConfig) -> list[bool]:
    """Whether each layer's FFN is an MoE, in the port's layer order (with
    ``moe_every=2``, each block's dense layer, then its MoE layer)."""
    if cfg.moe is None:
        return [False] * cfg.n_layers
    if cfg.moe_every not in (1, 2):
        raise ValueError("moe_every must be 1 or 2")
    if not _is_block(cfg):
        return [True] * cfg.n_layers
    if cfg.n_layers % 2:
        raise ValueError("moe_every=2 needs an even layer count")
    return [i % 2 == 1 for i in range(cfg.n_layers)]


def param_specs(cfg: LMConfig):
    pdt = cfg.param_dtype
    return {
        "embed": P((cfg.vocab, cfg.d_model), pdt, "embed"),
        "layers": [_layer_specs(cfg, moe=m) for m in _moe_layers(cfg)],
        "final_norm": P((cfg.d_model,), pdt, "ones"),
        "lm_head": P((cfg.d_model, cfg.vocab), pdt),
    }


def decay_mask(cfg: LMConfig) -> dict:
    """The leaves AdamW decays, as it decays the reference's: those the
    reference holds with ndim >= 2.  It stacks each layer's leaves as
    ``[L, ...]``, so it decays the layers' norm gains and biases too; of the
    1-D leaves only ``final_norm`` is left undecayed."""
    return {"embed": True, "final_norm": False, "lm_head": True,
            "layers": [{k: True for k in lp} for lp in param_specs(cfg)["layers"]]}


def stacked_groups(cfg: LMConfig) -> dict:
    """Each leaf's key in the reference's stacked layout: the per-layer
    leaves of one weight share the key of the reference's ``[L, ...]`` leaf
    (with ``moe_every=2``, of its "dense" or its "moe" stack).  Gradient
    compression scales each such group as the reference scales its leaf."""
    out = {k: k for k in ("embed", "final_norm", "lm_head")}
    out["layers"] = [{k: f"{('moe' if m else 'dense') if _is_block(cfg) else 'layers'}/{k}" for k in lp}
                     for m, lp in zip(_moe_layers(cfg), param_specs(cfg)["layers"])]
    return out


def init_params(cfg: LMConfig, generator: torch.Generator, *, device="cuda", dtype=None):
    """Random weights from ``generator`` on ``device``, stored in ``dtype``:
    ``cfg.dtype`` by default (serving), ``cfg.param_dtype`` for training's
    master weights."""
    return _init_params(param_specs(cfg), generator, device=device, dtype=dtype or cfg.dtype)


# ----------------------------------------------------------------- forward
def _qkv(h, lp, cfg: LMConfig, positions):
    B, S, _ = h.shape
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if cfg.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.d_head)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _ffn(h2, lp, cfg: LMConfig):
    """The layer's FFN on h2 [B, S, D]: (y, the MoE aux loss, 0.0 if dense)."""
    if "router" not in lp:
        return swiglu(h2, lp["w_gate"], lp["w_up"], lp["w_down"]), 0.0
    B, S, D = h2.shape
    y, aux = moe_ffn(h2.reshape(B * S, D), lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"], cfg.moe)
    return y.reshape(B, S, D), aux


def _cast(lp: dict, dtype) -> dict:
    return {k: w.to(dtype) for k, w in lp.items()}


def _layer(x, lp, cfg: LMConfig, positions):
    """One transformer layer; also returns its k, v [B, Hkv, S, dh] and
    its aux loss."""
    B, S, _ = x.shape
    lp = _cast(lp, x.dtype)
    h = rms_norm(x, lp["attn_norm"])
    q, k, v = _qkv(h, lp, cfg, positions)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    o = attention(q.transpose(1, 2), k, v, causal=True, impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                  remat=cfg.remat)
    o = o.transpose(1, 2).reshape(B, S, cfg.q_dim).to(x.dtype)    # [B, S, Hq*dh]
    x = x + o @ lp["wo"]
    h2 = rms_norm(x, lp["ffn_norm"])
    y, aux = _ffn(h2, lp, cfg)
    return x + y, k, v, aux


def _embed(params, tokens, cfg: LMConfig):
    """The rows of ``tokens``, cast after the lookup (``F.embedding``: its
    backward on CUDA sorts the ids and sums each row's repeats in a fixed
    order, so a training step replays bit for bit)."""
    return F.embedding(tokens, params["embed"]).to(cfg.dtype)


def _head(params, x):
    """Final norm and the vocabulary projection: logits in float32."""
    x = rms_norm(x, params["final_norm"].to(x.dtype))
    return (x @ params["lm_head"].to(x.dtype)).to(torch.float32)


def _train_layer(x, lp, cfg: LMConfig, positions):
    x, _, _, aux = _layer(x, lp, cfg, positions)
    return x, aux


def forward(params, tokens, cfg: LMConfig, rules: ShardingRules | None = None):
    """tokens [B, S] int -> (logits [B, S, V] float32, the layers' summed
    MoE aux loss, float32).  Under grad with ``cfg.remat`` each layer is a
    checkpoint region: the backward pass recomputes it from its input."""
    _check(rules)
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ckpt = cfg.remat and torch.is_grad_enabled()
    for lp in params["layers"]:
        if ckpt:
            x, a = checkpoint(_train_layer, x, lp, cfg, positions, use_reentrant=False)
        else:
            x, a = _train_layer(x, lp, cfg, positions)
        aux = aux + a
    return _head(params, x), aux


def lm_loss(params, batch, cfg: LMConfig, rules: ShardingRules | None = None):
    """batch: {"tokens": [B, S]} -> (next-token cross entropy + MoE aux,
    {"xent", "aux"})."""
    tokens = batch["tokens"]
    logits, aux = forward(params, tokens[:, :-1], cfg, rules)
    xent = softmax_xent(logits, tokens[:, 1:])
    return xent + aux, {"xent": xent, "aux": aux}


# ------------------------------------------------------------------ serving
@dataclass
class KVCache:
    k: torch.Tensor   # [L, B, Hkv, Smax, dh] in cfg.dtype
    v: torch.Tensor
    pos: int          # tokens written so far


def init_cache(cfg: LMConfig, batch: int, max_seq: int | None = None, *, device="cuda") -> KVCache:
    S = max_seq or cfg.max_seq
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, S, cfg.d_head)
    dev = resolve_device(device)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        pos=0,
    )


def prefill(params, tokens, cfg: LMConfig, rules: ShardingRules | None = None, *, max_seq: int | None = None):
    """Run the prompt; return (last-position logits [B, V] float32, filled
    KVCache).  The cache holds ``max_seq`` positions (default
    ``max(cfg.max_seq, S)``), zeros past the prompt."""
    _check(rules)
    B, S = tokens.shape
    Smax = max_seq or max(cfg.max_seq, S)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    shape = (cfg.n_layers, B, cfg.n_kv_heads, Smax, cfg.d_head)
    kall = torch.zeros(shape, dtype=cfg.dtype, device=x.device)
    vall = torch.zeros(shape, dtype=cfg.dtype, device=x.device)
    for i, lp in enumerate(params["layers"]):
        x, k, v, _ = _layer(x, lp, cfg, positions)
        kall[i, :, :, :S] = k
        vall[i, :, :, :S] = v
    logits = _head(params, x[:, -1])
    return logits, KVCache(k=kall, v=vall, pos=S)


def _decode_layer(x, lp, cfg: LMConfig, positions, attend):
    """One layer on one new token per sequence.  ``attend(q, k, v)`` (each
    [B, H, dh]) writes k and v into the layer's cache and returns the
    attention output [B, Hq, dh] in float32."""
    B = x.shape[0]
    lp = _cast(lp, x.dtype)
    h = rms_norm(x, lp["attn_norm"])
    q, k, v = _qkv(h, lp, cfg, positions)                           # [B, 1, H, dh]
    o = attend(q[:, 0], k[:, 0], v[:, 0])
    x = x + o.reshape(B, 1, cfg.q_dim).to(x.dtype) @ lp["wo"]
    h2 = rms_norm(x, lp["ffn_norm"])
    y, _ = _ffn(h2, lp, cfg)
    return x + y


def _attend_cache(q, k, v, kc, vc, pos, kv_lens):
    kc[:, :, pos] = k.to(kc.dtype)
    vc[:, :, pos] = v.to(vc.dtype)
    return attention(q[:, :, None], kc, vc, causal=True, kv_lens=kv_lens, impl="chunked")[:, :, 0]


def decode_step(params, cache: KVCache, tokens, cfg: LMConfig, rules: ShardingRules | None = None):
    """One token per sequence. tokens [B] -> (logits [B, V] float32, cache).

    Unlike the reference, which returns a new cache, the new token's k and v
    are written into ``cache``'s tensors in place (a copy of a 32k-token
    cache a step would double its memory); the returned cache shares them,
    with ``pos`` one further.
    """
    _check(rules)
    B = tokens.shape[0]
    pos = cache.pos
    if pos >= cache.k.shape[3]:
        raise ValueError(f"the cache holds {cache.k.shape[3]} positions, all written")
    x = _embed(params, tokens[:, None], cfg)                        # [B, 1, D]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    kv_lens = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
    for i, lp in enumerate(params["layers"]):
        x = _decode_layer(x, lp, cfg, positions, partial(_attend_cache, kc=cache.k[i], vc=cache.v[i],
                                                         pos=pos, kv_lens=kv_lens))
    logits = _head(params, x[:, 0])
    return logits, KVCache(k=cache.k, v=cache.v, pos=pos + 1)


def _attend_retrieval(q, k, v, kc, vc, cent, pos, cfg: LMConfig):
    cs = cfg.retrieval.cluster_size
    clustered_cache_update(kc, vc, cent, k, v, pos, cs)
    return retrieval_decode_attention(q, kc, vc, cent, pos + 1, cs=cs, top_b=cfg.retrieval.top_clusters)


def retrieval_decode_step(params, cache: ClusteredKVCache, tokens, cfg: LMConfig,
                          rules: ShardingRules | None = None):
    """Long-context decode with eCP retrieval attention (the paper's
    technique).  tokens [B] -> (logits [B, V] float32, cache).

    As ``decode_step``, the token's k and v and its cluster's centroid are
    written into ``cache``'s tensors in place, and the returned cache shares
    them with ``pos`` one further.
    """
    _check(rules)
    B = tokens.shape[0]
    pos = cache.pos
    nC, cs = cache.k.shape[3], cache.k.shape[4]
    if pos >= nC * cs:
        raise ValueError(f"the clustered cache holds {nC * cs} positions, all written")
    x = _embed(params, tokens[:, None], cfg)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    for i, lp in enumerate(params["layers"]):
        x = _decode_layer(x, lp, cfg, positions, partial(_attend_retrieval, kc=cache.k[i], vc=cache.v[i],
                                                         cent=cache.centroids[i], pos=pos, cfg=cfg))
    logits = _head(params, x[:, 0])
    return logits, ClusteredKVCache(k=cache.k, v=cache.v, centroids=cache.centroids, pos=pos + 1)
