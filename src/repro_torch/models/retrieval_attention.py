"""eCP retrieval attention for long-context decode: only its configuration so far.

``LMConfig`` carries a ``RetrievalAttnConfig``.  The clustered KV cache and
``retrieval_decode_attention`` (``repro.models.retrieval_attention``) wait
for ROADMAP Queue 1 #10.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["RetrievalAttnConfig"]


@dataclass(frozen=True)
class RetrievalAttnConfig:
    cluster_size: int = 512     # cs: tokens per KV cluster (eCP cluster cap)
    top_clusters: int = 32      # b: search expansion
