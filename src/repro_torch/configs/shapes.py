"""The input shapes, as the reference's (``repro.configs.shapes``).

Each entry's kind decides which step function runs: lm: train | prefill |
decode | retrieval_decode (long_500k); gnn: full_graph | sampled | graphs;
recsys: train | serve | retrieval (``user_tower`` then
``candidate_scores`` over ``n_candidates``).
"""
from __future__ import annotations

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    # needs sub-quadratic attention -> eCP retrieval attention (paper technique)
    "long_500k": dict(kind="retrieval_decode", seq=524288, batch=1),
}

GNN_SHAPES = {
    # Cora-scale full batch
    "full_graph_sm": dict(
        kind="full_graph", n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7
    ),
    # Reddit sampled training
    "minibatch_lg": dict(
        kind="sampled",
        n_nodes=232_965,
        n_edges=114_615_892,
        batch_nodes=1024,
        fanouts=(15, 10),
        d_feat=602,
        n_classes=41,
    ),
    # ogbn-products full batch
    "ogb_products": dict(
        kind="full_graph", n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_classes=47
    ),
    # batched small graphs
    "molecule": dict(
        kind="graphs", n_nodes=30, n_edges=64, batch=128, d_feat=16, n_classes=2
    ),
}

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}

FAMILY_SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}
