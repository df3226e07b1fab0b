"""The one traffic generator: a mix file's parameters and ``--seed`` in,
a reproducible schedule out.

Kinds of mix (``"kind"`` in ``traffic/<mix>.json``):

* ``closed``: ``outstanding`` single-image requests in flight; each
  answer is replaced by a new request, due at the moment the answer
  reached the host (a batch-scoring job, or cameras that each wait for
  their reply).
* ``poisson``: an open loop of single images at ``rate_per_s``: the
  count in a window of S seconds is fixed at round(rate x S), and the
  gaps between due times are those of that many uniform draws over the
  window, sorted (a Poisson process given its count). The draws come
  from a fixed stream, so every seed offers the same set of gaps, and
  the seed permutes their order.

Images are drawn from the run's pool in an order the seed permutes, and
the order cycles through the whole pool before it repeats.
"""

from __future__ import annotations

import dataclasses

import numpy as np

GAPS_SEED = 20230112  # the stream of a poisson mix's gaps, one for every seed


@dataclasses.dataclass(frozen=True)
class Schedule:
    kind: str
    order: np.ndarray          # pool index of request i (cycled)
    due_s: np.ndarray | None   # poisson: due time of request i in the window
    outstanding: int = 0       # closed: requests in flight

    def image(self, i: int) -> int:
        return int(self.order[i % len(self.order)])


def schedule(mix: dict, seed: int, seconds: float, pool: int) -> Schedule:
    rng = np.random.default_rng(int(seed))
    order = rng.permutation(pool)
    kind = mix["kind"]
    if kind == "closed":
        n = int(mix["outstanding"])
        if n < 1:
            raise ValueError("a closed loop needs outstanding >= 1")
        return Schedule(kind, order, None, n)
    if kind == "poisson":
        rate = float(mix["rate_per_s"])
        if rate <= 0:
            raise ValueError("rate_per_s must be positive")
        n = max(1, round(rate * seconds))
        fixed = np.random.default_rng(GAPS_SEED)
        gaps = np.diff(np.sort(fixed.uniform(0.0, seconds, n)), prepend=0.0)
        due = np.cumsum(rng.permutation(gaps))
        return Schedule(kind, order, due)
    raise ValueError(f"unknown traffic kind {kind!r}")
