"""Mixture-of-Experts FFN: top-1 routing, sort-based capacity dispatch.

The reference's ``repro.models.moe`` in PyTorch.  Tokens are sorted by
expert id (a stable sort, as ``jnp.argsort``: capacity keeps each expert's
first ``C`` tokens in token order), placed at their position within their
expert's group in an ``[E, C, D]`` buffer, the experts run as one batched
product over it, and the outputs go back to their tokens; tokens past an
expert's capacity come back as exact zeros.  On a decode step (T = 1) the
batched product reads every expert's weights: that is the reference's
dispatch, kept.

``moe_ffn_ep`` is expert parallelism over a mesh axis with no dispatch
all-to-all: the tokens are replicated over the axis and the experts
sharded, each rank runs the tokens whose top-1 expert it owns, and one
psum combines them.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..distributed import collectives as C
from ..launch.mesh import axis_index, axis_size

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


def moe_ffn_ep(x, router_w, w_gate, w_up, w_down, cfg: MoEConfig, *, mesh, model_axis: str, batch_axes=()):
    """Expert-parallel MoE over ``model_axis`` (the reference's shard_map body).

    x [T_loc, D]: this rank's tokens, sharded over ``batch_axes`` and
    REPLICATED over ``model_axis``; router_w [D, E] whole; w_gate/w_up
    [E_loc, D, F], w_down [E_loc, F, D]: this rank's ``E / size`` experts,
    from ``index * E_loc``.  Each rank routes every token, runs those whose
    top-1 expert it owns at a capacity from its *local* token count (as the
    reference), and contributes zeros for the rest; one psum over
    ``model_axis`` combines them.  The aux loss is the Switch loss over the
    tokens of all of ``batch_axes`` (replicated on every rank).  Returns
    ([T_loc, D] in x's dtype, aux).
    """
    T, D = x.shape
    E = cfg.n_experts
    n_m = axis_size(mesh, model_axis)
    if E % n_m:
        raise ValueError(f"{E} experts do not split over {n_m} ranks of {model_axis!r}")
    E_loc = E // n_m
    if w_gate.shape[0] != E_loc:
        raise ValueError(f"expected this rank's {E_loc} experts, got {w_gate.shape[0]}")
    C_ = capacity(cfg, T)
    lo = axis_index(mesh, model_axis) * E_loc
    probs, gate, eidx = route(x, router_w)
    dev = x.device
    mine = (eidx >= lo) & (eidx < lo + E_loc)
    e_loc = torch.where(mine, eidx - lo, E_loc)                        # E_loc: not this rank's
    order = torch.argsort(e_loc, stable=True)
    sorted_e = e_loc[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E_loc, device=dev))
    pos = torch.arange(T, device=dev) - starts[torch.clamp_max(sorted_e, E_loc - 1)]
    kept = (pos < C_) & (sorted_e < E_loc) & (pos >= 0)
    slot = torch.where(kept, sorted_e * C_ + pos, E_loc * C_)

    buf = torch.zeros((E_loc * C_ + 1, D), dtype=x.dtype, device=dev)
    buf[slot] = x[order]
    buf = buf[: E_loc * C_].view(E_loc, C_, D)
    g = F.silu(torch.bmm(buf, w_gate))
    u = torch.bmm(buf, w_up)
    y = torch.bmm(g * u, w_down)                                       # [E_loc, C, D]
    rows = y.reshape(E_loc * C_, D)[torch.where(kept, slot, 0)]
    out = torch.zeros((T, D), dtype=y.dtype, device=dev)
    out[order] = torch.where(kept[:, None], rows, torch.zeros((), dtype=y.dtype, device=dev))
    out = out * gate[:, None].to(y.dtype)
    out = C.all_reduce(out, mesh, model_axis)                           # one owner per token

    # the Switch aux loss over every token of the batch axes
    with torch.no_grad():
        counts = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
            0, eidx, torch.ones(T, dtype=torch.float32, device=dev))
        n_tok = C.all_reduce(torch.full((), float(T), device=dev), mesh, batch_axes)
        frac = C.all_reduce(counts, mesh, batch_axes) / n_tok
    mean_p = C.all_reduce(probs.sum(dim=0), mesh, batch_axes) / n_tok
    aux = E * torch.sum(frac * mean_p) * cfg.aux_loss_weight
    return out.to(x.dtype), aux
