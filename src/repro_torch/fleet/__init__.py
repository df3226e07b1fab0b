"""Contention-aware multi-model co-serving (``repro_torch.fleet``).

Serving N BNN models on one shared CPU + CUDA card composes the whole
stack — profiler tables, the DP mapper, serving engines, the adaptive
runtime, the profile store — under one new constraint: co-located
placements interfere.  Three pieces close that loop:

* :mod:`scheduler` — :func:`map_fleet`: coordinate-descent joint
  mapping over per-tenant contention-inflated ProfileTables
  (``cost_model.inflate_profile``), seeded at — and provably never
  worse than — the all-models-all-GPU assignment;
* :mod:`router` — :class:`FleetRouter`: priority/deadline dispatch
  into per-tenant ServingEngines with admission control (shed at the
  door rather than serve past the SLO), plus the
  :class:`QualityController` that degrades elastic tenants' subnet
  width under sustained shedding instead (``repro_torch.elastic``);
* :mod:`ledger` — :class:`DeviceTimeLedger`: metered per-tenant
  host/device occupancy feeding measured co-runner shares back into
  the joint mapper and the per-tenant drift loops.

The port of the JAX package's ``repro.fleet``: the same classes and
functions over the port's mapper and engines.
"""

from repro_torch.fleet.ledger import DeviceTimeLedger, TenantUsage
from repro_torch.fleet.router import (
    FleetRouter,
    QualityController,
    QualityRecord,
    Tenant,
)
from repro_torch.fleet.scheduler import (
    FleetPlan,
    TenantPlan,
    all_device_configuration,
    device_configs,
    joint_makespan,
    map_all_device,
    map_fleet,
    tenant_inflations,
)

__all__ = [
    "DeviceTimeLedger",
    "FleetPlan",
    "FleetRouter",
    "QualityController",
    "QualityRecord",
    "Tenant",
    "TenantPlan",
    "TenantUsage",
    "all_device_configuration",
    "device_configs",
    "joint_makespan",
    "map_all_device",
    "map_fleet",
    "tenant_inflations",
]
