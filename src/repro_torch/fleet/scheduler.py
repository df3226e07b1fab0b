"""Interference-aware joint mapping for a fleet of co-served BNNs.

HEP-BNN's mapper optimizes one model as if it owned the platform;
co-located tenants contend, and each model's "efficient" solo mapping
is jointly inefficient — typically every tenant maps onto the device
and they timeslice it.  :func:`map_fleet` searches the *joint*
assignment:

**Interference model.**  Tenant *j* running configuration *c_j*
demands a share of each processor — the fraction of its busy time
spent there (``EfficientConfiguration.placement_shares``, or measured
occupancy from a :class:`~repro_torch.fleet.ledger.DeviceTimeLedger`).  In
the saturated co-serving regime (every tenant continuously busy),
tenant *i*'s kernels on processor *p* stretch by
``contention_inflation(sum of co-runners' shares on p, gamma)``
(``repro_torch.core.cost_model``), so its wall time per example is its
mapping repriced on a per-tenant **contention-inflated table**
(:func:`repro_torch.core.cost_model.inflate_profile`).

**Objective.**  ``joint makespan`` — the wall time until every
tenant drains its workload, all running concurrently::

    makespan(assignment) = max_i  weight_i * inflated_time_i(assignment)

with ``weight_i`` the tenant's relative workload (examples to serve).

**Search.**  Coordinate descent: seed every tenant with its best
all-device mapping (the *all-GPU fleet assignment* — what N solo
HEP-BNN runs would deploy), then repeatedly re-run the existing
per-model DP (``map_efficient_configuration``) for one tenant at a
time against that tenant's contention-inflated table, accepting a
move only when it strictly lowers the joint makespan, until a full
round changes nothing (or ``max_rounds``).  Because the descent
starts *at* the all-GPU assignment and only ever accepts improving
moves, the returned plan is **provably never worse than
all-models-all-GPU under the same inflated cost model** — the
property ``tests/test_fleet.py`` asserts over random tables.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.cost_model import contention_inflation, inflate_profile
from repro_torch.core.mapper import (
    EfficientConfiguration,
    map_efficient_configuration,
    price_mapping,
)
from repro_torch.core.parallel_config import is_host_config
from repro_torch.core.profiler import ProfileTable


def device_configs(table: ProfileTable, registry=None) -> tuple:
    """Every device-placed config name appearing anywhere in `table` —
    the restriction that forces an all-device mapping."""
    names: list = []
    for b in table.batch_sizes:
        for i in range(len(table.layer_labels)):
            for c in table.configs_for(b, i):
                if not is_host_config(c, registry) and c not in names:
                    names.append(c)
    if not names:
        raise ValueError(
            f"table {table.model_name!r} has no device-placed configs"
        )
    return tuple(names)


def map_all_device(
    table: ProfileTable,
    *,
    batch_sizes: Sequence[int] | None = None,
    registry=None,
) -> EfficientConfiguration:
    """The strongest all-GPU mapping for one model: the DP restricted
    to device placements (any device variant per layer, best batch) —
    the per-tenant piece of the all-models-all-GPU fleet baseline.

    Canonical spelling of the legacy ``all_device_configuration``
    (part of the ``repro_torch.api`` verb set)."""
    return map_efficient_configuration(
        table,
        configs=device_configs(table, registry),
        policy="dp",
        batch_sizes=batch_sizes,
    )


@dataclasses.dataclass(frozen=True)
class TenantPlan:
    """One tenant's slice of a :class:`FleetPlan`.

    ``config`` is repriced on the tenant's contention-**inflated**
    table under the final assignment, so
    ``config.expected_time_per_example == inflated_expected_s`` for
    every tenant — the deployment-honest estimate consumers like the
    router's admission control read, consistent across tenants
    regardless of which descent step produced the mapping
    (``solo_expected_s`` keeps the uninflated view)."""

    name: str
    config: EfficientConfiguration
    host_share: float             # demand (or measured) share used
    device_share: float
    host_inflation: float         # factors the mapping was priced under
    device_inflation: float
    solo_expected_s: float        # per example, uninflated table
    inflated_expected_s: float    # per example, under co-runner load
    weight: float
    law: object = None            # fitted interference law, if any

    @property
    def makespan_s(self) -> float:
        return self.weight * self.inflated_expected_s


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """A joint assignment plus the evidence it beat the baseline."""

    tenants: tuple                # TenantPlan per model, input order
    joint_makespan_s: float
    baseline_makespan_s: float    # the all-GPU seed, same inflated model
    rounds: int                   # descent rounds executed
    converged: bool               # a full round changed nothing

    @property
    def configs(self) -> tuple:
        return tuple(t.config for t in self.tenants)

    @property
    def vs_all_gpu(self) -> float:
        """joint / all-GPU makespan ratio (<= 1.0 by construction)."""
        if self.baseline_makespan_s <= 0.0:
            return 1.0
        return self.joint_makespan_s / self.baseline_makespan_s


def _shares_of(
    tables,
    configs: Sequence[EfficientConfiguration],
    shares=None,
) -> list:
    """Per-tenant (host, device) shares: measured ones when given
    (``None`` entries fall back per tenant), else each mapping's
    demand profile **repriced on its own uninflated table** — so the
    share a tenant charges its co-runners depends only on (table,
    mapping, batch), never on which (possibly inflated) table happened
    to price the configuration object in hand."""
    out = []
    for i, cfg in enumerate(configs):
        measured = None if shares is None else shares[i]
        if measured is not None:
            out.append(measured)
            continue
        solo = price_mapping(
            tables[i], cfg.proper_batch_size, cfg.layer_configs
        )
        out.append(solo.placement_shares())
    return out


def tenant_inflations(
    tenant_shares: Sequence, index: int, *, gamma: float = 1.0, law=None
) -> tuple:
    """(host_factor, device_factor) for tenant `index` given every
    tenant's (host, device) share: co-runners' summed share on each
    processor, through :func:`contention_inflation`.  A fitted `law`
    (``repro_torch.estimator.FittedInterference``) replaces the linear
    ``gamma`` model on both processors."""
    co_host = sum(
        s[0] for j, s in enumerate(tenant_shares) if j != index
    )
    co_dev = sum(
        s[1] for j, s in enumerate(tenant_shares) if j != index
    )
    return (
        contention_inflation(co_host, gamma, law=law),
        contention_inflation(co_dev, gamma, law=law),
    )


def joint_makespan(
    tables: Sequence[ProfileTable],
    configs: Sequence[EfficientConfiguration],
    *,
    gamma: float = 1.0,
    law=None,
    weights: Sequence[float] | None = None,
    shares=None,
    registry=None,
) -> float:
    """The fleet objective: max over tenants of weighted per-example
    wall time, each tenant's mapping repriced on its
    contention-inflated table.  `shares` (per-tenant (host, device),
    e.g. from a ledger) overrides the demand model; `law` swaps the
    linear gamma model for a calibrated inflation law."""
    plans = _price_assignment(
        tables, configs, gamma=gamma, law=law, weights=weights,
        shares=shares, registry=registry,
    )
    return max(t.makespan_s for t in plans)


def _price_assignment(
    tables,
    configs,
    *,
    gamma,
    law=None,
    weights=None,
    shares=None,
    names=None,
    registry=None,
) -> tuple:
    if weights is None:
        weights = (1.0,) * len(tables)
    tenant_shares = _shares_of(tables, configs, shares)
    plans = []
    for i, (table, cfg) in enumerate(zip(tables, configs)):
        host_f, dev_f = tenant_inflations(
            tenant_shares, i, gamma=gamma, law=law
        )
        inflated = inflate_profile(
            table, host_factor=host_f, device_factor=dev_f,
            registry=registry,
        )
        batch = cfg.proper_batch_size
        priced = price_mapping(inflated, batch, cfg.layer_configs)
        solo = price_mapping(table, batch, cfg.layer_configs)
        plans.append(
            TenantPlan(
                name=names[i] if names else table.model_name,
                config=priced,
                host_share=tenant_shares[i][0],
                device_share=tenant_shares[i][1],
                host_inflation=host_f,
                device_inflation=dev_f,
                solo_expected_s=solo.expected_time_per_example,
                inflated_expected_s=priced.expected_time_per_example,
                weight=float(weights[i]),
                law=law,
            )
        )
    return tuple(plans)


def map_fleet(
    tables: Sequence[ProfileTable],
    *,
    names: Sequence[str] | None = None,
    policy: str = "dp",
    configs=None,
    batch_sizes: Sequence[int] | None = None,
    weights: Sequence[float] | None = None,
    shares=None,
    gamma: float = 1.0,
    law=None,
    max_rounds: int = 8,
    registry=None,
) -> FleetPlan:
    """Jointly map N co-served models (one ProfileTable each) under
    the contention-inflation model (module docstring).

    ``configs``/``batch_sizes``/``policy`` restrict each per-tenant DP
    exactly as in :func:`map_efficient_configuration`.  ``shares`` is
    an optional per-tenant list of measured (host, device) occupancy
    pairs — ``DeviceTimeLedger.shares()`` values — overriding the
    demand model per tenant (``None`` entries fall back); ``weights``
    are relative workload sizes.  ``law`` replaces the linear
    ``gamma`` model with a calibrated inflation law
    (``repro_torch.estimator.InterferenceFit().fit()``) — the descent's
    never-worse guarantee only needs monotonicity, which the
    fitted-law contract provides.  Returns a :class:`FleetPlan` whose
    ``joint_makespan_s <= baseline_makespan_s`` always holds: the
    descent seeds at the all-GPU fleet assignment and only accepts
    strictly improving moves.
    """
    if not tables:
        raise ValueError("map_fleet needs at least one tenant table")
    if names is not None and len(names) != len(tables):
        raise ValueError("names must match tables one-to-one")
    if shares is not None and len(shares) != len(tables):
        raise ValueError("shares must match tables one-to-one")
    if weights is not None and len(weights) != len(tables):
        raise ValueError("weights must match tables one-to-one")

    def makespan(assignment) -> float:
        return joint_makespan(
            tables, assignment, gamma=gamma, law=law, weights=weights,
            shares=shares, registry=registry,
        )

    # seed: the all-GPU fleet assignment — N solo deployments
    assignment = [
        map_all_device(t, batch_sizes=batch_sizes, registry=registry)
        for t in tables
    ]
    baseline = best = makespan(assignment)

    rounds = 0
    converged = False
    for rounds in range(1, max_rounds + 1):
        changed = False
        for i, table in enumerate(tables):
            tenant_shares = _shares_of(tables, assignment, shares)
            host_f, dev_f = tenant_inflations(
                tenant_shares, i, gamma=gamma, law=law
            )
            inflated = inflate_profile(
                table, host_factor=host_f, device_factor=dev_f,
                registry=registry,
            )
            candidate = map_efficient_configuration(
                inflated, policy=policy, configs=configs,
                batch_sizes=batch_sizes,
            )
            if (
                candidate.layer_configs,
                candidate.proper_batch_size,
            ) == (
                assignment[i].layer_configs,
                assignment[i].proper_batch_size,
            ):
                continue
            trial = list(assignment)
            trial[i] = candidate
            m = makespan(trial)
            if m < best:
                assignment, best, changed = trial, m, True
        if not changed:
            converged = True
            break

    return FleetPlan(
        tenants=_price_assignment(
            tables, assignment, gamma=gamma, law=law, weights=weights,
            shares=shares, names=names, registry=registry,
        ),
        joint_makespan_s=best,
        baseline_makespan_s=baseline,
        rounds=rounds,
        converged=converged,
    )


def all_device_configuration(
    table: ProfileTable,
    *,
    batch_sizes: Sequence[int] | None = None,
    registry=None,
) -> EfficientConfiguration:
    """Deprecated spelling of :func:`repro_torch.api.map_all_device` — kept
    importable; warns once per call site and delegates."""
    from repro_torch._compat import warn_deprecated

    warn_deprecated("all_device_configuration", "map_all_device")
    from repro_torch import api

    return api.map_all_device(
        table, batch_sizes=batch_sizes, registry=registry
    )
