"""Mixture-of-Experts FFN: top-1 routing, sort-based capacity dispatch.

The reference's ``repro.models.moe`` in PyTorch.  Tokens are sorted by
expert id (a stable sort, as ``jnp.argsort``: capacity keeps each expert's
first ``C`` tokens in token order), placed at their position within their
expert's group in an ``[E, C, D]`` buffer, the experts run as one batched
product over it, and the outputs go back to their tokens; tokens past an
expert's capacity come back as exact zeros.  On a decode step (T = 1) the
batched product reads every expert's weights: that is the reference's
dispatch, kept.

``moe_ffn_ep`` (expert parallelism over a mesh) waits for the distribution
layer (ROADMAP Queue 1 #13).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

__all__ = ["MoEConfig", "moe_ffn", "moe_ffn_ep"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int = 1                 # assigned archs use top-1 (Switch-style)
    d_ff: int = 8192
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


def capacity(cfg: MoEConfig, T: int) -> int:
    """Tokens an expert takes out of ``T``."""
    return max(1, int(cfg.capacity_factor * T / cfg.n_experts))


def route(x, router_w):
    """Top-1 routing of ``x`` [T, D]: (softmax probabilities [T, E] from
    float32 logits, gate [T], expert index [T] int64; the first index on
    ties, as ``jnp.argmax``)."""
    probs = torch.softmax(x.to(torch.float32) @ router_w.to(torch.float32), dim=-1)
    return probs, probs.amax(dim=-1), torch.argmax(probs, dim=-1)


def moe_ffn(x, router_w, w_gate, w_up, w_down, cfg: MoEConfig):
    """x [T, D] -> ([T, D], aux loss). Top-1 routing with capacity drop.

    router_w [D, E]; w_gate/w_up [E, D, F]; w_down [E, F, D].
    """
    T, D = x.shape
    E = cfg.n_experts
    C = capacity(cfg, T)
    probs, gate, eidx = route(x, router_w)

    # Switch load-balancing aux loss: E * sum_e f_e * P_e
    counts = torch.zeros(E, dtype=torch.int64, device=x.device).index_add_(0, eidx, torch.ones_like(eidx))
    frac = counts.to(torch.float32) / T
    aux = E * torch.sum(frac * probs.mean(dim=0)) * cfg.aux_loss_weight

    order = torch.argsort(eidx, stable=True)
    sorted_e = eidx[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=x.device))
    pos_in_e = torch.arange(T, device=x.device) - starts[sorted_e]
    kept = pos_in_e < C
    # every shape static (the dry run traces it on fake tensors): the sorted
    # tokens go to their [E * C] slots, the dropped ones to one spare row
    slot = torch.where(kept, sorted_e * C + pos_in_e, E * C)

    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    buf[slot] = x[order]
    buf = buf[: E * C].view(E, C, D)
    g = F.silu(torch.bmm(buf, w_gate))
    u = torch.bmm(buf, w_up)
    y = torch.bmm(g * u, w_down)                                      # [E, C, D]

    rows = y.reshape(E * C, D)[torch.where(kept, slot, 0)]
    out = torch.zeros((T, D), dtype=y.dtype, device=x.device)
    out[order] = torch.where(kept[:, None], rows, torch.zeros((), dtype=y.dtype, device=x.device))
    out = out * gate[:, None].to(y.dtype)
    return out.to(x.dtype), aux


def moe_ffn_ep(*args, **kwargs):
    raise NotImplementedError(
        "moe_ffn_ep (expert parallelism over a mesh) is not ported yet (ROADMAP Queue 1 #13)"
    )
