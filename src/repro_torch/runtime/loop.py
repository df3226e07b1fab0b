"""Fault-tolerant training loop.

Contract (restart-anywhere):
  * data batches are a pure function of (seed, step) — restart replays
    nothing and skips nothing (repro_torch.data.loader),
  * checkpoints are atomic and self-validating (repro_torch.ckpt),
  * the loop always begins by restoring the latest valid checkpoint,
    so crash -> relaunch converges to exactly-once step semantics,
  * a watchdog flags straggling steps (wall-time > k x EMA); it is
    surfaced in the metrics and through an optional callback.

Each step's time is taken after a sync on the device its metrics live
on, so the straggler EMA sees the device's time, not the enqueue.

Failure injection: ``inject_failure_at`` raises mid-run (between a
step's commit and the next checkpoint) — tests use it to prove
recovery resumes with identical state and loss trajectory.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.tree import leaves


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str
    save_every: int = 50
    keep: int = 3
    async_save: bool = False
    straggler_factor: float = 3.0
    ema_alpha: float = 0.2
    inject_failure_at: Optional[int] = None


def _sync(tree) -> None:
    """Wait for the CUDA devices the tensors of `tree` live on."""
    for dev in {t.device for t in leaves(tree)
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


class TrainLoop:
    """step_fn(state, batch) -> (state, metrics); state is any tree of
    tensors (e.g. a ``TrainState``), metrics a dict of 0-d tensors or
    numbers."""

    def __init__(
        self,
        step_fn: Callable,
        batch_fn: Callable[[int], Any],
        state: Any,
        cfg: LoopConfig,
        *,
        on_straggler: Optional[Callable[[int, float], None]] = None,
    ):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.state = state
        self.cfg = cfg
        self.on_straggler = on_straggler
        self.mgr = CheckpointManager(
            cfg.ckpt_dir, save_every=cfg.save_every, keep=cfg.keep,
            async_save=cfg.async_save,
        )
        self.start_step = 0
        self.metrics_log: list = []

    def restore_if_available(self):
        """Load the latest valid checkpoint into ``self.state`` (each
        tensor on the device of the one it replaces)."""
        step, restored = self.mgr.restore_latest(self.state)
        if step is not None:
            self.state = restored
            self.start_step = step
        return self.start_step

    def run(self) -> dict:
        cfg = self.cfg
        self.restore_if_available()
        ema = None
        for step in range(self.start_step, cfg.total_steps):
            t0 = time.perf_counter()
            batch = self.batch_fn(step)
            self.state, metrics = self.step_fn(self.state, batch)
            _sync(metrics)
            dt = time.perf_counter() - t0

            straggle = False
            if ema is not None and dt > cfg.straggler_factor * ema:
                straggle = True
                if self.on_straggler:
                    self.on_straggler(step, dt)
            ema = dt if ema is None else (
                (1 - cfg.ema_alpha) * ema + cfg.ema_alpha * dt
            )

            rec = {
                "step": step + 1,
                "sec": dt,
                "straggler": straggle,
                **{k: float(v) for k, v in metrics.items()},
            }
            self.metrics_log.append(rec)

            done = step + 1
            self.mgr.save(done, self.state)
            if done == cfg.inject_failure_at:
                raise InjectedFailure(f"injected failure after step {done}")
        self.mgr.save(cfg.total_steps, self.state, force=True)
        self.mgr.wait()
        return {
            "final_step": cfg.total_steps,
            "metrics": self.metrics_log,
        }
