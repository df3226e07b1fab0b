"""Shard-aware batcher with exact-resume semantics.

Batch indices are a pure function of (seed, step): after a restart at
step s the stream continues identically — required by the fault-
tolerance contract (see repro_torch.runtime.loop).  Pure NumPy, the
JAX package's batcher: equal indices for equal arguments.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ShardedBatcher:
    n: int                 # dataset size
    global_batch: int
    seed: int = 0
    shard_index: int = 0   # this host's shard of the global batch
    num_shards: int = 1

    def __post_init__(self):
        if self.global_batch % self.num_shards:
            raise ValueError("global_batch must divide evenly over shards")
        self.local_batch = self.global_batch // self.num_shards

    def indices(self, step: int) -> np.ndarray:
        """Global batch indices for `step`, then this host's slice."""
        rng = np.random.default_rng((self.seed, step))
        idx = rng.integers(0, self.n, size=self.global_batch)
        lo = self.shard_index * self.local_batch
        return idx[lo : lo + self.local_batch]

    def batch(self, arrays, step: int):
        idx = self.indices(step)
        return tuple(a[idx] for a in arrays)
