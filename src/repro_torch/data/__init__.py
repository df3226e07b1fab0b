"""Deterministic synthetic data: streams are pure functions of
(seed, step), so training resumes exactly after a restart."""

from repro_torch.data.loader import ShardedBatcher
from repro_torch.data.synthetic import (
    ImageDataset,
    make_image_dataset,
    make_token_stream,
)

__all__ = ["ImageDataset", "make_image_dataset", "make_token_stream",
           "ShardedBatcher"]
