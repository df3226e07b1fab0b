"""HEP-BNN core on torch — profile, map, plan, execute.

* :mod:`parallel_config` — the per-layer implementation space: the
  paper's fixed 8 (CPU + 7 X/Y/Z aspect configurations) plus any name
  registered in :mod:`repro_torch.kernels.registry`.
* :mod:`profiler` — per-layer latency across implementations and batch
  sizes, host configs on CPU tensors and device configs on the card,
  with the host<->device boundary costs timed separately (or priced by
  the H100 model); ``autotune_bnn_model`` sweeps the registry's open
  space with warm-up pruning.
* :mod:`mapper` — the paper's greedy Algorithm 1 and the
  transfer-aware Viterbi DP -> :class:`EfficientConfiguration`.
* :mod:`plan` — the segment plan IR and fused-segment selection.
* :mod:`mapped_model` — the one executor over plan nodes.
* :mod:`cost_model` — the pricing algebra (segments, pipeline,
  contention) and the analytic H100 model.
* :mod:`hep_shard` — the paper's algorithm lifted to the sharding
  scheme: greedy coordinate descent over ``ShardScheme`` knobs, each
  trial a measured step on the card.
"""

from repro_torch.core.parallel_config import (
    ASPECT_CONFIGS,
    CONFIGS,
    aspects_of,
    is_host_config,
)
from repro_torch.core.mapper import (
    EfficientConfiguration,
    Segment,
    best_uniform,
    configuration_from_mapping,
    map_efficient_configuration,
    price_mapping,
    segments_of,
    uniform_total,
)
from repro_torch.core.profiler import (
    ProfileTable,
    autotune_bnn_model,
    profile_bnn_model,
    profile_segment_variants,
)
from repro_torch.core.plan import build_plan, fuse_configuration, fuse_mapping
from repro_torch.core.mapped_model import build_mapped_model, build_segment_fns
from repro_torch.core.hep_shard import ShardTrial, search

__all__ = [
    "ASPECT_CONFIGS",
    "CONFIGS",
    "EfficientConfiguration",
    "ProfileTable",
    "Segment",
    "ShardTrial",
    "aspects_of",
    "autotune_bnn_model",
    "best_uniform",
    "build_mapped_model",
    "build_plan",
    "build_segment_fns",
    "configuration_from_mapping",
    "fuse_configuration",
    "fuse_mapping",
    "is_host_config",
    "map_efficient_configuration",
    "price_mapping",
    "profile_bnn_model",
    "profile_segment_variants",
    "search",
    "segments_of",
    "uniform_total",
]
