"""Tenant-to-host placement: bin-pack tenants onto N logical hosts
under the same contention model ``map_fleet`` prices with.

Each host is modelled as one heterogeneous CPU + card machine running
its own serving stack (``FleetRouter`` + ``DeviceTimeLedger``).  A
tenant's *demand* is its ``placement_shares()`` profile — the fraction
of per-example work it asks of each processor — weighted by its
relative request rate.  Placement is the classic decreasing-demand
greedy bin-pack, except the "bin level" is not a scalar: a candidate
host's cost is the contention-priced
:func:`repro_torch.fleet.scheduler.joint_makespan` of its resident
tenants plus the candidate, so two
device-heavy tenants repel each other onto different hosts while a
host-heavy and a device-heavy tenant pack together cheaply (they
contend on different processors).

After assignment every host's resident set is jointly mapped with
:func:`map_fleet` — placement decides *who shares a machine*, the
fleet mapper decides *how each machine splits its layers* given the
co-residents placement chose.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.fleet.scheduler import FleetPlan, joint_makespan, map_fleet


@dataclasses.dataclass(frozen=True)
class HostAssignment:
    """One host's slice of a :class:`ClusterPlan`."""

    host_id: int
    tenant_names: tuple
    # contention-priced makespan of the resident set (the bin level
    # the packer minimized), and the host's joint fleet mapping
    priced_makespan_s: float
    fleet_plan: FleetPlan

    def to_dict(self) -> dict:
        return {
            "host_id": self.host_id,
            "tenants": list(self.tenant_names),
            "priced_makespan_s": self.priced_makespan_s,
            "joint_makespan_s": self.fleet_plan.joint_makespan_s,
        }


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """The full placement: who lives where, at what priced cost."""

    assignments: tuple            # HostAssignment per host, id order

    @property
    def n_hosts(self) -> int:
        return len(self.assignments)

    def host_of(self, tenant: str) -> int:
        for a in self.assignments:
            if tenant in a.tenant_names:
                return a.host_id
        raise KeyError(tenant)

    def config_of(self, tenant: str):
        """The tenant's jointly-mapped configuration on its host."""
        a = self.assignments[self.host_of(tenant)]
        i = a.tenant_names.index(tenant)
        return a.fleet_plan.tenants[i].config

    @property
    def makespan_s(self) -> float:
        """Cluster makespan: hosts run in parallel, so the cluster is
        as slow as its slowest host."""
        return max(
            (a.fleet_plan.joint_makespan_s for a in self.assignments
             if a.tenant_names),
            default=0.0,
        )

    def to_dict(self) -> dict:
        return {
            "n_hosts": self.n_hosts,
            "makespan_s": self.makespan_s,
            "hosts": [a.to_dict() for a in self.assignments],
        }


def _demand(tp) -> float:
    """Scalar demand for sort order: weighted per-example time."""
    return tp.weight * tp.config.expected_time_per_example


def place_tenants(
    tenants: Sequence,
    n_hosts: int,
    *,
    gamma: float = 1.0,
    law=None,
    policy: str = "dp",
    configs: Sequence[str] | None = None,
    batch_sizes: Sequence[int] | None = None,
    registry=None,
) -> ClusterPlan:
    """Assign `tenants` (``repro_torch.api.TenantPlan``-like: ``.name``,
    ``.table``, ``.config``, ``.weight``) to `n_hosts` hosts.

    Decreasing-demand greedy: heaviest tenant first, each placed on
    the host whose priced joint makespan grows least.  Ties (e.g. all
    empty hosts at the start) break toward the lower host id, so the
    packing is deterministic.  Hosts left empty stay in the plan with
    an empty resident set — the elastic controller retires them.
    """
    if n_hosts < 1:
        raise ValueError("n_hosts must be >= 1")
    order = sorted(tenants, key=_demand, reverse=True)
    residents: list = [[] for _ in range(n_hosts)]

    for tp in order:
        best_host, best_cost = 0, math.inf
        for h in range(n_hosts):
            trial = residents[h] + [tp]
            cost = joint_makespan(
                [t.table for t in trial],
                [t.config for t in trial],
                gamma=gamma, law=law,
                weights=[t.weight for t in trial],
                registry=registry,
            )
            if cost < best_cost - 1e-12:
                best_host, best_cost = h, cost
        residents[best_host].append(tp)

    assignments = []
    for h in range(n_hosts):
        group = residents[h]
        names = tuple(t.name for t in group)
        if group:
            plan = map_fleet(
                [t.table for t in group],
                names=names, policy=policy, configs=configs,
                batch_sizes=batch_sizes,
                weights=[t.weight for t in group],
                gamma=gamma, law=law, registry=registry,
            )
            priced = joint_makespan(
                [t.table for t in group], list(plan.configs),
                gamma=gamma, law=law,
                weights=[t.weight for t in group], registry=registry,
            )
        else:
            plan = FleetPlan(
                tenants=(), joint_makespan_s=0.0,
                baseline_makespan_s=0.0, rounds=0, converged=True,
            )
            priced = 0.0
        assignments.append(HostAssignment(
            host_id=h, tenant_names=names,
            priced_makespan_s=priced, fleet_plan=plan,
        ))
    return ClusterPlan(assignments=tuple(assignments))
