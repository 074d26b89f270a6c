"""The LM and recsys input shapes, as the reference's
(``repro.configs.shapes.LM_SHAPES``, ``RECSYS_SHAPES``).

Each entry's kind decides which step function runs: lm: train | prefill |
decode | retrieval_decode (long_500k); recsys: train | serve | retrieval
(``user_tower`` then ``candidate_scores`` over ``n_candidates``).
"""
from __future__ import annotations

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    # needs sub-quadratic attention -> eCP retrieval attention (paper technique)
    "long_500k": dict(kind="retrieval_decode", seq=524288, batch=1),
}

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}
