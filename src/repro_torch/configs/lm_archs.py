"""The dense LM architectures the port runs, exact configs as the reference's
(``repro.configs.lm_archs``).

Sources: phi4-mini [arXiv:2412.08905], qwen2-7b [arXiv:2407.10671].  The
MoE configs (llama4 maverick/scout) wait for ``moe.py`` and mistral-large
(123B, four cards) for the distribution layer (ROADMAP Queue 1 #11, #13).
"""
from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.models.retrieval_attention import RetrievalAttnConfig
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"

_RETR = RetrievalAttnConfig(cluster_size=512, top_clusters=32)


def phi4_mini_full() -> LMConfig:
    return LMConfig(
        name="phi4-mini-3.8b", n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=200064, d_head=128, qkv_bias=False, retrieval=_RETR,
    )


def qwen2_7b_full() -> LMConfig:
    return LMConfig(
        name="qwen2-7b", n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab=152064, d_head=128, qkv_bias=True, retrieval=_RETR,
    )


def _reduced(full: LMConfig) -> LMConfig:
    """Same family, smoke scale: tiny widths, few layers, CPU-friendly."""
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
        retrieval=RetrievalAttnConfig(cluster_size=16, top_clusters=2),
        attn_chunk=64,
    )


ARCHS = {
    "phi4-mini-3.8b": phi4_mini_full,
    "qwen2-7b": qwen2_7b_full,
}


def get(arch_id: str, *, reduced: bool = False) -> LMConfig:
    if arch_id not in ARCHS:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet (ported: {sorted(ARCHS)}; MoE and mistral-large: ROADMAP Queue 1 #11, #13)"
        )
    cfg = ARCHS[arch_id]()
    return _reduced(cfg) if reduced else cfg
