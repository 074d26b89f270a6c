"""Fault tolerance: a supervised training loop with checkpoint/restart,
straggler detection and bounded retry (the reference's, on one process).

  * step-granular checkpoints (CheckpointManager, atomic rename publish):
    a failure costs at most ``ckpt_every`` steps of work;
  * restore-latest + deterministic StepLoader: the replayed batches are
    the failure-free run's, so a restart is invisible;
  * straggler detection: a step's wall time against the rolling median;
    steps slower than ``straggler_factor`` x the median are counted;
  * bounded retries with exponential re-open backoff.

A checkpoint comes back as host numpy; the supervisor puts each restored
leaf on the device of the state's matching leaf before the next step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..tree import tree_map

__all__ = ["TrainSupervisor", "FailureInjector", "onto_devices_of"]


@dataclass
class FailureInjector:
    """Deterministic failure schedule for tests: fail at given steps."""

    fail_at: dict = field(default_factory=dict)  # step -> n remaining failures

    def maybe_fail(self, step: int) -> None:
        left = self.fail_at.get(step, 0)
        if left > 0:
            self.fail_at[step] = left - 1
            raise RuntimeError(f"injected failure at step {step}")


def onto_devices_of(restored, like):
    """``restored`` (a tree of host numpy, as ``CheckpointManager.restore``
    returns it) with each leaf a tensor of ``like``'s matching leaf's shape
    on its device (the file structure reads a 0-d leaf, the optimizer's
    step, back as shape (1,), in both packages); leaves where ``like`` holds
    no tensor stay as they are."""

    def place(r, ref):
        if isinstance(ref, torch.Tensor):
            return torch.from_numpy(np.array(r)).reshape(ref.shape).to(ref.device)
        return r

    return tree_map(place, restored, like)


@dataclass
class TrainSupervisor:
    step_fn: Callable                 # (state, batch, step) -> (state, metrics)
    loader: Any                       # StepLoader
    ckpt: CheckpointManager
    ckpt_every: int = 50
    max_retries: int = 8
    straggler_factor: float = 3.0

    def run(
        self,
        state,
        n_steps: int,
        *,
        start_step: int = 0,
        injector: FailureInjector | None = None,
        on_metrics: Callable | None = None,
    ):
        step = start_step
        retries = 0
        durations: list[float] = []
        stragglers = 0
        restarts = 0
        while step < n_steps:
            batch = self.loader.global_batch(step)
            t0 = time.perf_counter()
            try:
                if injector is not None:
                    injector.maybe_fail(step)
                state, metrics = self.step_fn(state, batch, step)
            except Exception:
                retries += 1
                restarts += 1
                if retries > self.max_retries:
                    raise
                restored, ck_step = self.ckpt.restore()
                if restored is not None:
                    state = onto_devices_of(restored, state)
                    step = ck_step
                else:
                    step = start_step
                time.sleep(min(0.01 * 2**retries, 0.25))  # re-open backoff
                continue
            retries = 0
            dt = time.perf_counter() - t0
            durations.append(dt)
            med = sorted(durations)[len(durations) // 2]
            if len(durations) >= 5 and dt > self.straggler_factor * med:
                stragglers += 1
            if on_metrics is not None:
                on_metrics(step, metrics, dt)
            step += 1
            if step % self.ckpt_every == 0 or step == n_steps:
                self.ckpt.save(step, state)
        self.ckpt.wait()
        return state, {"restarts": restarts, "stragglers": stragglers, "steps": len(durations)}
