"""HEP-Shard: the paper's mapping algorithm lifted to the sharding
scheme — the counterpart of ``repro.core.hep_shard``.

Algorithm 1's skeleton with substitutions:
  layer implementation   ->  ShardScheme knob value
  profiled wall-clock    ->  a trial of the cell under the scheme
                             (the caller's ``evaluate``: on one card, a
                             measured train step)
  batch-size sweep       ->  knob sweep via greedy coordinate descent
                             (one knob at a time, argmin cost, repeat
                             until fixpoint)

Cost = max(compute, memory) + collective + the host<->device transfer,
plus a hard penalty when the peak bytes exceed the device memory (a
config that does not fit is not a config, it is an OOM).

The device memory is the card's (``torch.cuda.get_device_properties``,
read when a cost is asked for), where the JAX package fixes the v5e's
16 GiB; :attr:`ShardTrial.hbm_bytes` sets it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.parallel.sharding import ShardScheme

__all__ = ["KNOBS", "OOM_PENALTY", "ShardTrial", "device_hbm_bytes",
           "search"]

OOM_PENALTY = 1e6


def device_hbm_bytes(device=None) -> int:
    """The card's memory in bytes (``None`` -> the current CUDA device;
    raises without one)."""
    import torch

    from repro_torch.device import resolve_device

    return torch.cuda.get_device_properties(
        resolve_device(device)).total_memory


@dataclasses.dataclass
class ShardTrial:
    scheme: ShardScheme
    compute_s: float
    memory_s: float
    collective_s: float
    peak_bytes: int
    # kernel-vs-transfer split: host<->device staging charged separately
    # from the on-device step
    h2d_s: float = 0.0
    d2h_s: float = 0.0
    # the device memory the peak is held to; None: the card's
    hbm_bytes: Optional[int] = None

    @property
    def kernel_s(self) -> float:
        """On-device step time: overlapped compute/memory + collective."""
        return max(self.compute_s, self.memory_s) + self.collective_s

    @property
    def transfer_s(self) -> float:
        return self.h2d_s + self.d2h_s

    @property
    def cost(self) -> float:
        c = self.kernel_s + self.transfer_s
        hbm = self.hbm_bytes
        if hbm is None:
            hbm = device_hbm_bytes()
        if self.peak_bytes > hbm:
            c += OOM_PENALTY * (self.peak_bytes / hbm)
        return c


KNOBS = {
    "tp": (True, False),
    "fsdp": ("zero1", "zero3", "none"),
    "expert_mode": ("auto", "ep", "tp"),
    "batch_over_model": (False, True),
    "seq_over_model": (False, True),
    "attn_kv_parallel": (False, True),
    "out_proj_contracting_2d": (False, True),
    "accum_steps": (1, 4, 8),
}


def search(
    evaluate: Callable[[ShardScheme], ShardTrial],
    start: Optional[ShardScheme] = None,
    *,
    knobs: Optional[dict] = None,
    max_rounds: int = 3,
    log: Optional[Callable[[str], None]] = print,
) -> tuple:
    """Greedy coordinate descent over the scheme lattice.

    `evaluate` runs the cell under a scheme and returns its trial (each
    scheme is evaluated once).  Returns (best ShardTrial, history
    list).
    """
    current = start or ShardScheme()
    knobs = knobs or KNOBS
    seen: dict = {}

    def ev(scheme: ShardScheme) -> ShardTrial:
        key = dataclasses.astuple(scheme)
        if key not in seen:
            seen[key] = evaluate(scheme)
        return seen[key]

    best = ev(current)
    history = [best]
    for round_ in range(max_rounds):
        improved = False
        for knob, values in knobs.items():       # Alg.1 foreach layer
            trials = []
            for v in values:                     # Alg.1 foreach implem
                cand = dataclasses.replace(current, **{knob: v})
                try:
                    trials.append(ev(cand))
                except Exception as e:           # an invalid combo is a
                    if log:                      # profiled failure, not
                        log(f"  {knob}={v}: {e!r}")  # a crash
                    continue
            if not trials:                       # every value failed:
                if log:                          # the knob is a no-op
                    log(f"  {knob}: all values failed, skipping")
                continue
            t = min(trials, key=lambda t: t.cost)
            if t.cost < best.cost - 1e-12:       # Alg.1 argmin
                best = t
                current = t.scheme
                improved = True
                if log:
                    log(
                        f"  round {round_} {knob} -> "
                        f"{getattr(t.scheme, knob)}: cost {t.cost:.4f}s"
                    )
            history.append(t)
        if not improved:
            break
    return best, history
