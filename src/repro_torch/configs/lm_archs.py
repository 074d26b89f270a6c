"""The five LM architectures, exact configs as the reference's
(``repro.configs.lm_archs``).

Sources: phi4-mini [arXiv:2412.08905], mistral-large
[hf:mistralai/Mistral-Large-Instruct-2407], qwen2-7b [arXiv:2407.10671],
llama4 maverick/scout [hf:meta-llama/Llama-4-*].  Maverick alternates dense
and MoE layers (``moe_every=2``: 128 experts x 48 layers, ~400B in all,
17B active); scout is MoE in every layer.  Of the reference's training
fields the port's ``LMConfig`` has the two of one device, ``remat`` and
``microbatches``; the distribution fields (``fsdp_axis``, ``pure_fsdp``)
wait for a mesh (ROADMAP Queue 1 #13), as mistral-large's 123B parameters
wait for four cards.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.retrieval_attention import RetrievalAttnConfig
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"

_RETR = RetrievalAttnConfig(cluster_size=512, top_clusters=32)


def phi4_mini_full() -> LMConfig:
    return LMConfig(
        name="phi4-mini-3.8b", n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=200064, d_head=128, qkv_bias=False, retrieval=_RETR,
    )


def mistral_large_full() -> LMConfig:
    return LMConfig(
        name="mistral-large-123b", n_layers=88, d_model=12288, n_heads=96,
        n_kv_heads=8, d_ff=28672, vocab=32768, d_head=128,
        param_dtype=torch.bfloat16, microbatches=2, retrieval=_RETR,
    )


def qwen2_7b_full() -> LMConfig:
    return LMConfig(
        name="qwen2-7b", n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab=152064, d_head=128, qkv_bias=True, retrieval=_RETR,
    )


def llama4_maverick_full() -> LMConfig:
    return LMConfig(
        name="llama4-maverick-400b-a17b", n_layers=48, d_model=5120, n_heads=40,
        n_kv_heads=8, d_ff=8192, vocab=202048, d_head=128,
        moe=MoEConfig(n_experts=128, top_k=1, d_ff=8192), moe_every=2,
        param_dtype=torch.bfloat16, retrieval=_RETR,
    )


def llama4_scout_full() -> LMConfig:
    return LMConfig(
        name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
        n_kv_heads=8, d_ff=8192, vocab=202048, d_head=128,
        moe=MoEConfig(n_experts=16, top_k=1, d_ff=8192), moe_every=1,
        retrieval=_RETR,
    )


def _reduced(full: LMConfig) -> LMConfig:
    """Same family, smoke scale: tiny widths, few layers, CPU-friendly."""
    moe = None
    if full.moe is not None:
        moe = MoEConfig(n_experts=4, top_k=1, d_ff=96, capacity_factor=full.moe.capacity_factor)
    return replace(
        full,
        n_layers=4 if full.moe_every == 2 else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        d_head=16,
        max_seq=128,
        dtype=torch.float32,
        param_dtype=torch.float32,
        moe=moe,
        retrieval=RetrievalAttnConfig(cluster_size=16, top_clusters=2),
        attn_chunk=64,
    )


ARCHS = {
    "phi4-mini-3.8b": phi4_mini_full,
    "mistral-large-123b": mistral_large_full,
    "qwen2-7b": qwen2_7b_full,
    "llama4-maverick-400b-a17b": llama4_maverick_full,
    "llama4-scout-17b-a16e": llama4_scout_full,
}


def get(arch_id: str, *, reduced: bool = False) -> LMConfig:
    cfg = ARCHS[arch_id]()
    return _reduced(cfg) if reduced else cfg
