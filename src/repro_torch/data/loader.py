"""Deterministic, restart-safe batch loader (the reference's
``repro.data.loader``).

The loader is a pure map step -> global batch, optionally pre-sharded per
data-parallel rank.  There is no iterator state to lose on failure:
resuming at step S after a restart replays exactly the batches a
failure-free run would have seen.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

__all__ = ["StepLoader"]


@dataclass
class StepLoader:
    """make(seed, step, shard) -> dict of np arrays for that shard."""

    make: Callable
    seed: int = 0
    n_shards: int = 1

    def global_batch(self, step: int) -> dict:
        shards = [self.make(self.seed, step, shard=s) for s in range(self.n_shards)]
        if self.n_shards == 1:
            return shards[0]
        return {
            k: np.concatenate([s[k] for s in shards], axis=0) for k in shards[0]
        }

    def shard_batch(self, step: int, shard: int) -> dict:
        return self.make(self.seed, step, shard=shard)
