"""The train step of the reference's ``launch/cells.py``:
``make_train_step(loss_fn, opt, *, microbatches=1)``, and
``value_and_grad``, its gradient through torch autograd.

The rest of the reference's module (cells, shardings, abstract inputs,
lowering for the dry run) belongs to the distribution layer and waits for
ROADMAP Queue 1 #13.
"""
from __future__ import annotations

import torch

from ..optim import apply_updates
from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["make_train_step", "value_and_grad", "to_device"]


def to_device(batch, device):
    """Numpy leaves of ``batch`` as tensors on ``device``; tensors moved."""
    return tree_map(lambda x: torch.as_tensor(x, device=device), batch)


def value_and_grad(loss_fn, params, batch):
    """((loss, metrics), grads) of ``loss_fn(params, batch) -> (loss,
    metrics)``, as ``jax.value_and_grad(..., has_aux=True)``: the gradient
    of every parameter (zeros where the loss does not reach it), the loss
    and the metrics detached.  ``params`` need not require grad."""
    leaves = tree_leaves(params)
    xs = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, xs), batch)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads)]
    detach = lambda m: m.detach() if isinstance(m, torch.Tensor) else m
    return (loss.detach(), tree_map(detach, metrics)), tree_unflatten(params, grads)


def make_train_step(loss_fn, opt, *, microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``batch``'s numpy leaves go to the parameters' device.  microbatches >
    1: gradient accumulation over that many chunks of the batch's leading
    axis, in float32: activation memory scales 1/n while the optimizer
    state is touched once.  The optimizer works in place (``optim.adamw``):
    the returned params and state are the ones passed in, updated.
    """

    def step(params, opt_state, batch):
        batch = to_device(batch, tree_leaves(params)[0].device)
        if microbatches <= 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        else:
            def split(x):
                return x.reshape((microbatches, x.shape[0] // microbatches) + tuple(x.shape[1:]))

            chunks = tree_map(split, batch)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            loss, ms = 0.0, []
            for i in range(microbatches):
                (l, m), g = value_and_grad(loss_fn, params, tree_map(lambda c: c[i], chunks))
                grads = tree_map(lambda a, b: a.add_(b.to(a.dtype)), grads, g)
                loss = loss + l
                ms.append(m)
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = tree_map(lambda *xs: torch.mean(torch.stack(xs), dim=0), *ms)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss, **metrics}

    return step
