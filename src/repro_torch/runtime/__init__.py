"""Runtime: the fault-tolerant training loop, its watchdog, and the
elastic re-mesh."""

from repro_torch.runtime.elastic import remesh_state
from repro_torch.runtime.loop import InjectedFailure, LoopConfig, TrainLoop

__all__ = ["TrainLoop", "LoopConfig", "InjectedFailure", "remesh_state"]
