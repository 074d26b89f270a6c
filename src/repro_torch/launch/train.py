"""End-to-end trainer (the reference's ``launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
      --reduced --steps 20 --device cpu

Runs a reduced (or full) LM config on one device: deterministic data,
AdamW + cosine schedule, a checkpoint every N steps through the supervisor
(restart-safe), optional int8 gradient compression.  ``--device`` defaults
to ``cuda``.  The step is a plain function (no compilation, no buffer
donation): the optimizer updates the state's tensors in place.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from dataclasses import replace
from functools import partial

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_arch
from ..data import StepLoader, lm_batch
from ..device import resolve_device
from ..distributed import TrainSupervisor
from ..models import transformer as T
from ..optim import adamw, apply_updates, compress_decompress, init_ef_state, warmup_cosine
from .cells import to_device, value_and_grad

__all__ = ["make_lm_trainer", "main"]


def make_lm_trainer(cfg: T.LMConfig, *, lr=3e-4, total_steps=10_000, compress=False, device="cuda"):
    """(step, init): ``init(generator)`` -> state ``(params, opt_state,
    ef)``, float32 master weights (``cfg.param_dtype``) drawn from
    ``generator`` on ``device``; ``step(state, batch, *, mark=None)`` ->
    (state, metrics), the batch's numpy tokens moved to ``device``.
    ``mark(name)``, when given, is called once the gradients are issued
    ("grads") and once the update is ("update"): the hook by which a caller
    times the step's two halves."""
    dev = resolve_device(device)
    opt = adamw(warmup_cosine(lr, min(200, total_steps // 10 + 1), total_steps), decay_mask=T.decay_mask(cfg))
    loss_fn = lambda p, b: T.lm_loss(p, b, cfg)
    groups = T.stacked_groups(cfg)

    def step(state, batch, *, mark=None):
        params, opt_state, ef = state
        (loss, metrics), grads = value_and_grad(loss_fn, params, to_device(batch, dev))
        if mark is not None:
            mark("grads")
        if compress:
            grads, ef = compress_decompress(grads, ef, groups=groups)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        if mark is not None:
            mark("update")
        return (params, opt_state, ef), {"loss": loss, **metrics}

    def init(generator: torch.Generator):
        params = T.init_params(cfg, generator, device=dev, dtype=cfg.param_dtype)
        ef = init_ef_state(params) if compress else None
        return (params, opt.init(params), ef)

    return step, init


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    family, cfg = get_arch(args.arch, reduced=args.reduced)
    if family != "lm":
        raise SystemExit("train.py drives LM archs")
    cfg = replace(cfg, max_seq=args.seq)
    dev = resolve_device(args.device)
    step, init = make_lm_trainer(cfg, lr=args.lr, total_steps=args.steps, compress=args.compress, device=dev)
    state = init(torch.Generator(device=dev).manual_seed(0))

    loader = StepLoader(
        make=partial(lm_batch, batch=args.batch, seq=args.seq, vocab=cfg.vocab),
        seed=0,
    )
    ckpt = CheckpointManager(args.ckpt_dir, keep_n=2)

    losses = []

    def on_metrics(i, metrics, dt):
        losses.append(float(metrics["loss"]))
        if i % args.log_every == 0:
            print(
                f"step {i:5d} loss {float(metrics['loss']):.4f} "
                f"xent {float(metrics.get('xent', 0.0)):.4f} {dt*1e3:.0f} ms",
                flush=True,
            )

    sup = TrainSupervisor(
        step_fn=lambda s, b, i: step(s, b),
        loader=loader,
        ckpt=ckpt,
        ckpt_every=args.ckpt_every,
    )
    t0 = time.time()
    state, stats = sup.run(state, args.steps, on_metrics=on_metrics)
    dt = time.time() - t0
    print(
        f"done: {args.steps} steps in {dt:.1f}s on {dev}; loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
        f"restarts={stats['restarts']} stragglers={stats['stragglers']}"
    )


if __name__ == "__main__":
    main()
