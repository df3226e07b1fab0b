"""Optimizers, schedules and gradient compression over tensor trees:
the JAX package's ``repro.optim``, function for function."""

from repro_torch.optim.compression import (
    Int8ErrorFeedback,
    compress_bf16,
    decompress_bf16,
)
from repro_torch.optim.optimizers import (
    Optimizer,
    OptState,
    adamw,
    clip_by_global_norm,
    lion,
    sgd,
)
from repro_torch.optim.schedules import (
    constant_schedule,
    cosine_schedule,
    linear_warmup_cosine,
)

__all__ = [
    "OptState", "Optimizer", "adamw", "sgd", "lion", "clip_by_global_norm",
    "constant_schedule", "cosine_schedule", "linear_warmup_cosine",
    "compress_bf16", "decompress_bf16", "Int8ErrorFeedback",
]
