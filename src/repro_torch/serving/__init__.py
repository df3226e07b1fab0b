"""Serving runtime for HEP-mapped BNNs on a CPU + CUDA card.

* :mod:`pipeline` — :class:`SegmentPipeline`: executes the mapper's
  segments as a two-stage host/device software pipeline (queued CUDA
  work, pinned non-blocking H2D one wave early, event-synchronised
  deferred D2H).
* :mod:`batcher` — :class:`MicroBatcher`: dynamic request coalescing
  with max-batch / max-wait knobs and padding to profiled batch sizes.
* :mod:`engine` — :class:`ServingEngine`: the front end gluing the two
  together behind ``submit()`` / ``step()``, with batch-boundary
  configuration hot-swap (``swap_configuration``).
"""

from repro_torch.serving.batcher import MicroBatch, MicroBatcher, Request, pad_to
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.pipeline import SegmentPipeline, canonical_mixed_mapping

__all__ = [
    "MicroBatch",
    "MicroBatcher",
    "Request",
    "SegmentPipeline",
    "ServingEngine",
    "canonical_mixed_mapping",
    "pad_to",
]
