"""Gradient compression for the cross-pod all-reduce (the reference's
``repro.optim.compress``).

int8 uniform quantization with error feedback (EF-SGD style): each leaf is
scaled by its absmax, rounded to int8 (half to even, as ``jnp.round``), and
the quantization residual is carried to the next step.  On one device the
round trip runs on the gradients before the optimizer, the numerics of the
reference's compressed reduce; the reduce itself waits for the
distribution layer (ROADMAP Queue 1 #13).
"""
from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["init_ef_state", "compress_decompress", "quantize_int8", "dequantize_int8"]


def quantize_int8(x, absmax=None):
    """(int8 codes, float32 scale) of ``x`` on a scale of ``absmax`` (by
    default ``x``'s own largest magnitude) / 127."""
    if absmax is None:
        absmax = torch.max(torch.abs(x))
    absmax = torch.clamp_min(absmax, 1e-12)
    # a tensor divisor: CUDA multiplies by the reciprocal of a scalar one
    scale = absmax / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def init_ef_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


@torch.no_grad()
def compress_decompress(grads, ef_state, *, groups=None):
    """The quantize -> dequantize round trip with error feedback: returns
    (decompressed grads in their own dtypes, the new error-feedback state).

    Each leaf has its own scale, as the reference's, unless ``groups`` (a
    tree of keys shaped like ``grads``) puts leaves on one: the leaves of a
    key share the largest magnitude among them.  The LM trainer groups each
    weight's per-layer leaves, which the reference holds as one stacked
    ``[L, ...]`` leaf (``transformer.stacked_groups``)."""
    gl, el = tree_leaves(grads), tree_leaves(ef_state)
    keys = tree_leaves(groups) if groups is not None else list(range(len(gl)))
    absmax = {}
    for k, g, e in zip(keys, gl, el):
        m = torch.max(torch.abs(g.to(torch.float32) + e))
        absmax[k] = m if k not in absmax else torch.maximum(absmax[k], m)
    deq, err = [], []
    for k, g, e in zip(keys, gl, el):
        corrected = g.to(torch.float32) + e
        q, scale = quantize_int8(corrected, absmax[k])
        d = dequantize_int8(q, scale)
        deq.append(d.to(g.dtype))
        err.append(corrected - d)
    return tree_unflatten(grads, deq), tree_unflatten(grads, err)
