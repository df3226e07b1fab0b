"""Elastic BNNs: degrade width, not availability.

One trained, packed BNN yields a family of K nested-width subnets —
each narrower level a word-prefix slice of the same packed bitplane
tensors (:mod:`repro_torch.elastic.subnet`), each planned/priced
through the ordinary profile→map→fuse chain under a level-tagged store
key
(:mod:`repro_torch.elastic.planner`), all K resident behind one
:class:`ElasticEngine` that switches level at batch boundaries
(:mod:`repro_torch.elastic.engine`).  The
:class:`~repro_torch.fleet.router.QualityController` closes the loop:
sustained shedding hot-swaps a tenant one level narrower before more
requests die at the door; sustained headroom restores width —
honoring per-tenant ``quality_floor`` and journaling every transition.
"""

from repro_torch.elastic.engine import ElasticEngine
from repro_torch.elastic.planner import ElasticPlan, plan_family
from repro_torch.elastic.subnet import (
    ElasticSpec,
    SubnetFamily,
    SubnetLevel,
    level_name,
    slice_packed,
    slice_params_fp,
)
from repro_torch.fleet.router import QualityController, QualityRecord

__all__ = [
    "ElasticEngine",
    "ElasticPlan",
    "ElasticSpec",
    "QualityController",
    "QualityRecord",
    "SubnetFamily",
    "SubnetLevel",
    "level_name",
    "plan_family",
    "slice_packed",
    "slice_params_fp",
]
