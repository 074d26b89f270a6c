"""Shared neural layers (pure functions over parameter tensors).

The cast points are the reference's (``repro.models.layers``): the norms
compute in float32 and cast back to the input's dtype before the gain,
``rope`` computes its angles in float32 and casts its output back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "layer_norm", "swiglu", "gelu_mlp", "rope", "dense", "softmax_xent", "bce_logits"]


def rms_norm(x, gamma, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    scale = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * gamma


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y.to(x.dtype) * gamma) + beta


def dense(x, w, b=None):
    y = x @ w
    if b is not None:
        y = y + b
    return y


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU FFN: (silu(x Wg) * x Wu) Wd."""
    g = F.silu(x @ w_gate)
    u = x @ w_up
    return (g * u) @ w_down


def gelu_mlp(x, w1, b1, w2, b2):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ w1 + b1, approximate="tanh") @ w2 + b2


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding. x [..., S, H, d]; positions [..., S]."""
    d = x.shape[-1]
    half = d // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device) * (log_theta.to(x.device) / half)
    )
    angles = positions[..., :, None].to(torch.float32) * freqs[None, :]  # [..., S, half]
    cos = torch.cos(angles)[..., :, None, :]   # [..., S, 1, half]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softmax_xent(logits, labels, *, mask=None):
    """Mean cross-entropy over valid positions. logits [..., V], labels [...]"""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    nll = lse - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def bce_logits(logits, labels):
    """Binary cross-entropy with logits; mean over batch."""
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    return torch.mean(
        torch.clamp_min(logits, 0.0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))
    )
