"""The LM input shapes, as the reference's (``repro.configs.shapes.LM_SHAPES``).

Each entry's kind decides which step function runs: train | prefill |
decode | retrieval_decode (long_500k).
"""
from __future__ import annotations

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    # needs sub-quadratic attention -> eCP retrieval attention (paper technique)
    "long_500k": dict(kind="retrieval_decode", seq=524288, batch=1),
}
