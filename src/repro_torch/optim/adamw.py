"""AdamW with decoupled weight decay, global-norm clipping, lr schedules.

The reference's functional API (``repro.optim.adamw``):
  opt = adamw(lr_schedule, wd=0.1, clip=1.0)
  state = opt.init(params)
  updates, state = opt.update(grads, state, params)
  params = apply_updates(params, updates)

The state is the reference's tree, ``{"mu", "nu", "step"}`` (``"mom"``
and ``"step"`` for SGD), so a checkpoint holds the same leaves; ``step``
is a 0-d int32 tensor on the parameters' device.  The arithmetic is the
reference's, in the same order: float32 throughout, moments stored in
``moment_dtype``, bias correction from the float32 step, weight decay only
where ``p.ndim >= 2`` (or ``decay_mask(p)``; the port also takes a tree of
bools shaped like the parameters, by which the LM trainer decays what the
reference decays in its stacked layout, ``transformer.decay_mask``).

Unlike the reference, which returns new arrays, every call works in place
under ``torch.no_grad()``: ``update`` writes the moments into the state's
tensors and each float32 gradient's update into that gradient's storage
(so ``grads`` is consumed), and ``apply_updates`` adds into the
parameters.  A step then holds one tree each of weights, gradients and
moments and one leaf of temporaries, not a second tree of each: this is
what lets phi4-mini's 4.45 B float32 parameters train on one 80 GB card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten
from .schedule import constant

__all__ = ["Optimizer", "adamw", "sgd_momentum", "apply_updates", "global_norm"]


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(params, updates):
    """``p + u`` cast to ``p``'s dtype, written into ``p``; returns ``params``."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        p.add_(u)
    return params


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def _device(params) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def _clipped(grads: list, clip: float | None, gn=None) -> list:
    """Each gradient in float32, scaled by ``min(1, clip / max(|g|, 1e-12))``
    when ``clip`` is set (in place for float32 gradients); ``gn``: the
    global norm where the gradients are one rank's shards."""
    g32 = [g.to(torch.float32) for g in grads]
    if clip is None:
        return g32
    if gn is None:
        gn = torch.sqrt(sum(torch.sum(torch.square(g)) for g in g32))
    scale = torch.clamp_max(torch.full_like(gn, clip) / torch.clamp_min(gn, 1e-12), 1.0)
    return [g.mul_(scale) for g in g32]


def _into(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The float32 update ``u``, in ``g``'s storage when ``g`` is float32."""
    return g.copy_(u) if g.dtype == torch.float32 and g is not u else u


def adamw(
    lr: Callable | float,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    wd: float = 0.1,
    clip: float | None = 1.0,
    decay_mask=None,              # p -> bool, or a tree of bools like the params
    moment_dtype=torch.float32,   # bf16 moments halve the optimizer's memory
) -> Optimizer:
    lr_fn = lr if callable(lr) else constant(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
        return {
            "mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=_device(params)),
        }

    @torch.no_grad()
    def update(grads, state, params, *, grad_norm=None):
        step = state["step"] + 1
        gl = tree_leaves(grads)
        g32 = _clipped(gl, clip, grad_norm)
        stepf = step.to(torch.float32)
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf
        lr_t = lr_fn(step)
        pl = tree_leaves(params)
        if decay_mask is None:
            decay = [p.ndim >= 2 for p in pl]
        elif callable(decay_mask):
            decay = [bool(decay_mask(p)) for p in pl]
        else:
            decay = tree_leaves(decay_mask)
        out = []
        for g0, g, m, v, p, dec in zip(gl, g32, tree_leaves(state["mu"]), tree_leaves(state["nu"]), pl, decay):
            if m.dtype == torch.float32:
                m.mul_(b1).add_(g * (1 - b1))
                v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            else:   # round once, from the float32 sum, as the reference's astype
                m.copy_(b1 * m.to(torch.float32) + (1 - b1) * g)
                v.copy_(b2 * v.to(torch.float32) + (1 - b2) * torch.square(g))
            del g
            u = (m.to(torch.float32) / bc1).mul_(lr_t)
            u.div_(torch.sqrt(v.to(torch.float32) / bc2).add_(eps)).neg_()
            if wd > 0 and dec:
                u.sub_(p.to(torch.float32) * (lr_t * wd))
            out.append(_into(g0, u))
        return tree_unflatten(grads, out), {"mu": state["mu"], "nu": state["nu"], "step": step}

    return Optimizer(init=init, update=update)


def sgd_momentum(lr, *, momentum: float = 0.9, clip: float | None = None) -> Optimizer:
    lr_fn = lr if callable(lr) else constant(lr)

    def init(params):
        return {
            "mom": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=_device(params)),
        }

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        gl = tree_leaves(grads)
        lr_t = lr_fn(step)
        out = []
        for g0, g, m in zip(gl, _clipped(gl, clip), tree_leaves(state["mom"])):
            m.mul_(momentum).add_(g)
            out.append(_into(g0, m * (-lr_t)))
        return tree_unflatten(grads, out), {"mom": state["mom"], "step": step}

    return Optimizer(init=init, update=update)
