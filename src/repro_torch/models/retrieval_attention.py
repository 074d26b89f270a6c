"""eCP retrieval attention for long-context decode: only its configuration so far.

``LMConfig`` carries a ``RetrievalAttnConfig``.  What is left of ROADMAP
Queue 1 #10 is this module: ``ClusteredKVCache``, ``init_clustered_cache``,
``clustered_cache_update`` and ``retrieval_decode_attention``
(``repro.models.retrieval_attention``), and
``transformer.retrieval_decode_step``; #10's other half, the recsys models
(``models/recsys.py``), is ported.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["RetrievalAttnConfig"]


@dataclass(frozen=True)
class RetrievalAttnConfig:
    cluster_size: int = 512     # cs: tokens per KV cluster (eCP cluster cap)
    top_clusters: int = 32      # b: search expansion
