"""Learning-rate schedules: functions of the step counter (an int or a
tensor), computed in float32 as the reference's (``repro.optim.schedule``),
returned as a 0-d float32 tensor on the step's device."""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "warmup_cosine", "warmup_linear_decay"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32, device=_f32(step).device)


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int, *, floor: float = 0.1):
    def fn(step):
        step = _f32(step)
        warm = peak * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return fn


def warmup_linear_decay(peak: float, warmup_steps: int, total_steps: int):
    def fn(step):
        step = _f32(step)
        warm = peak * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        return torch.where(step < warmup_steps, warm, peak * (1 - frac))

    return fn
