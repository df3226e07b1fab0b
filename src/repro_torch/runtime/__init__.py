"""Runtime: the fault-tolerant training loop and its watchdog."""

from repro_torch.runtime.loop import InjectedFailure, LoopConfig, TrainLoop

__all__ = ["TrainLoop", "LoopConfig", "InjectedFailure"]
