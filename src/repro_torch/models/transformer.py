"""Decoder-only LM family on one device: dense GQA transformers.

The reference's model (``repro.models.transformer``) as plain functions over
a parameter dict: RoPE, SwiGLU, GQA, optional QKV bias.  The serving path
is ``prefill`` (the prompt, attention by ``cfg.attn_impl``: ``"flash"``
runs the Hopper kernel in every layer) and then ``decode_step`` (one token,
chunked attention over the cache, as the reference does on one device).

Parameters: ``{"embed": [V, D], "layers": [per-layer dict] * n_layers,
"final_norm": [D], "lm_head": [D, V]}``; the reference stacks the layers
as ``[L, ...]`` arrays and scans them, the port keeps them apart and loops.
Every weight is held in ``cfg.dtype``, cast once when it is made or loaded
(``init_params``, ``base.params_from_jax``): numerically what the
reference's ``_cast_layers`` and per-use ``.astype(cfg.dtype)`` give, at
half the memory of float32 weights in bf16.

Not ported yet, each raising ``NotImplementedError``: MoE FFNs (``cfg.moe``,
ROADMAP Queue 1 #11), sharding rules (Queue 1 #13), ``retrieval_decode_step``
and the clustered cache (Queue 1 #10), ``lm_loss`` and training (Queue 1
#11).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from ..device import resolve_device
from .attention import attention
from .base import ParamSpec as P
from .base import init_params as _init_params
from .layers import rms_norm, rope, swiglu
from .retrieval_attention import RetrievalAttnConfig

__all__ = [
    "LMConfig", "ShardingRules", "KVCache", "param_specs", "init_params", "forward", "lm_loss",
    "prefill", "decode_step", "retrieval_decode_step", "init_cache",
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
    moe: Any = None                 # MoE FFN config; not ported (Queue 1 #11)
    moe_every: int = 1
    retrieval: RetrievalAttnConfig = field(default_factory=RetrievalAttnConfig)
    attn_impl: str = "chunked"      # full | chunked | flash
    attn_chunk: int = 1024

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head


def _check(cfg: LMConfig, rules) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE FFNs are not ported yet (ROADMAP Queue 1 #11)")
    if rules is not None and (rules.batch or rules.model is not None or rules.seq is not None):
        raise NotImplementedError("sharding rules are not ported yet: the port runs on one device (ROADMAP Queue 1 #13)")


# ------------------------------------------------------------------ params
def _layer_specs(cfg: LMConfig) -> dict:
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
    layers["w_gate"] = P((D, F), pdt)
    layers["w_up"] = P((D, F), pdt)
    layers["w_down"] = P((F, D), pdt)
    return layers


def param_specs(cfg: LMConfig):
    _check(cfg, None)
    pdt = cfg.param_dtype
    return {
        "embed": P((cfg.vocab, cfg.d_model), pdt, "embed"),
        "layers": [_layer_specs(cfg) for _ in range(cfg.n_layers)],
        "final_norm": P((cfg.d_model,), pdt, "ones"),
        "lm_head": P((cfg.d_model, cfg.vocab), pdt),
    }


def init_params(cfg: LMConfig, generator: torch.Generator, *, device="cuda"):
    """Random weights from ``generator`` on ``device``, stored in ``cfg.dtype``."""
    return _init_params(param_specs(cfg), generator, device=device, dtype=cfg.dtype)


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


def _ffn(h2, lp):
    return swiglu(h2, lp["w_gate"], lp["w_up"], lp["w_down"])


def _layer(x, lp, cfg: LMConfig, positions):
    """One transformer layer; also returns its k, v [B, Hkv, S, dh]."""
    B, S, _ = x.shape
    h = rms_norm(x, lp["attn_norm"])
    q, k, v = _qkv(h, lp, cfg, positions)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    o = attention(q.transpose(1, 2), k, v, causal=True, impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    o = o.transpose(1, 2).reshape(B, S, cfg.q_dim).to(x.dtype)    # [B, S, Hq*dh]
    x = x + o @ lp["wo"]
    h2 = rms_norm(x, lp["ffn_norm"])
    return x + _ffn(h2, lp), k, v


def _embed(params, tokens, cfg: LMConfig):
    return params["embed"][tokens].to(cfg.dtype)


def forward(params, tokens, cfg: LMConfig, rules: ShardingRules | None = None):
    """tokens [B, S] int -> (logits [B, S, V] float32, aux loss 0)."""
    _check(cfg, rules)
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    for lp in params["layers"]:
        x, _, _ = _layer(x, lp, cfg, positions)
    x = rms_norm(x, params["final_norm"])
    logits = (x @ params["lm_head"]).to(torch.float32)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def lm_loss(params, batch, cfg: LMConfig, rules: ShardingRules | None = None):
    raise NotImplementedError("lm_loss and training (with a backward flash kernel) are not ported yet (ROADMAP Queue 1 #11)")


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
    _check(cfg, rules)
    B, S = tokens.shape
    Smax = max_seq or max(cfg.max_seq, S)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    shape = (cfg.n_layers, B, cfg.n_kv_heads, Smax, cfg.d_head)
    kall = torch.zeros(shape, dtype=cfg.dtype, device=x.device)
    vall = torch.zeros(shape, dtype=cfg.dtype, device=x.device)
    for i, lp in enumerate(params["layers"]):
        x, k, v = _layer(x, lp, cfg, positions)
        kall[i, :, :, :S] = k
        vall[i, :, :, :S] = v
    x = rms_norm(x, params["final_norm"])
    logits = (x[:, -1] @ params["lm_head"]).to(torch.float32)
    return logits, KVCache(k=kall, v=vall, pos=S)


def decode_step(params, cache: KVCache, tokens, cfg: LMConfig, rules: ShardingRules | None = None):
    """One token per sequence. tokens [B] -> (logits [B, V] float32, cache).

    Unlike the reference, which returns a new cache, the new token's k and v
    are written into ``cache``'s tensors in place (a copy of a 32k-token
    cache a step would double its memory); the returned cache shares them,
    with ``pos`` one further.
    """
    _check(cfg, rules)
    B = tokens.shape[0]
    pos = cache.pos
    if pos >= cache.k.shape[3]:
        raise ValueError(f"the cache holds {cache.k.shape[3]} positions, all written")
    x = _embed(params, tokens[:, None], cfg)                        # [B, 1, D]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    kv_lens = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
    for i, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["attn_norm"])
        q, k, v = _qkv(h, lp, cfg, positions)                       # [B, 1, H, dh]
        cache.k[i, :, :, pos] = k[:, 0].to(cache.k.dtype)
        cache.v[i, :, :, pos] = v[:, 0].to(cache.v.dtype)
        o = attention(q.transpose(1, 2), cache.k[i], cache.v[i], causal=True, kv_lens=kv_lens, impl="chunked")
        o = o.transpose(1, 2).reshape(B, 1, cfg.q_dim).to(x.dtype)
        x = x + o @ lp["wo"]
        h2 = rms_norm(x, lp["ffn_norm"])
        x = x + _ffn(h2, lp)
    x = rms_norm(x, params["final_norm"])
    logits = (x[:, 0] @ params["lm_head"]).to(torch.float32)
    return logits, KVCache(k=cache.k, v=cache.v, pos=pos + 1)


def retrieval_decode_step(params, cache, tokens, cfg: LMConfig, rules: ShardingRules | None = None):
    raise NotImplementedError("retrieval_decode_step and the clustered KV cache are not ported yet (ROADMAP Queue 1 #10)")
