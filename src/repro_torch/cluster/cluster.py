"""The cluster orchestrator: placement, dispatch, serving, scaling.

:class:`Cluster` is what ``repro_torch.api.Deployment`` stands up for
``hosts > 1``.  It owns the pool of
:class:`~repro_torch.cluster.host.ServingHost`\\ s, places tenants
with :func:`~repro_torch.cluster.placement.place_tenants`, routes
requests through a pluggable dispatch policy, and (optionally) lets an
:class:`~repro_torch.cluster.elastic.ElasticController` grow and
shrink the pool.  Every host's engines serve on the cluster's one
`device`: the hosts of one process share its CPU and its card.

Re-planning invariant: every engine in the cluster serves the same
proper batch size (placement maps with one ``batch_sizes`` entry), so
topology changes that re-map a host's residents can apply with the
engine's batch-boundary **hot swap** — a scale event never rebuilds a
live engine, and every in-flight request completes under exactly one
configuration.

With a shared ``store`` (any :class:`~repro_torch.store.ProfileStore`
backend — typically ``sqlite://`` so every host reads one file), the
cluster persists each host's jointly-mapped configurations under that
co-tenancy's :func:`~repro_torch.store.fleet_scope`, and scale events
**warm-start from the cache**: a replication whose exact resident
group was mapped before loads the stored configurations instead of
re-running the joint mapper (``cache_hits``/``cache_misses`` count
the outcomes).
"""

from __future__ import annotations

import time
from typing import Sequence

from repro_torch.cluster.dispatch import make_policy
from repro_torch.cluster.elastic import ElasticController
from repro_torch.cluster.host import ACTIVE, RETIRED, ServingHost
from repro_torch.cluster.placement import place_tenants
from repro_torch.fleet.scheduler import map_fleet
from repro_torch.store import ProfileStore, fleet_scope


class Cluster:
    def __init__(
        self,
        tenant_plans: Sequence,
        *,
        n_hosts: int = 2,
        gamma: float = 1.0,
        law=None,
        policy=None,
        mapping_policy: str = "dp",
        configs: Sequence[str] | None = None,
        batch_sizes: Sequence[int] | None = None,
        registry=None,
        engine_factory=None,
        elastic=None,
        clock=time.monotonic,
        occupancy_window: int = 16,
        engine_kwargs: dict | None = None,
        store=None,
        device=None,
    ):
        """`tenant_plans` are ``repro_torch.api.TenantPlan``-like bundles
        (model, packed params, profile table, solo configuration).
        `elastic` is ``None`` (fixed pool), an
        :class:`ElasticController`, or a dict of its knobs.  `store`
        is an optional shared :class:`~repro_torch.store.ProfileStore` (or
        backend URI) all hosts read mappings through (module
        docstring); a URI is keyed by `device`'s fingerprint.  Every
        engine the hosts build serves on `device` (``None`` ->
        ``cuda``)."""
        self.tenants = {tp.name: tp for tp in tenant_plans}
        if len(self.tenants) != len(tenant_plans):
            raise ValueError("tenant names must be unique")
        self._gamma = gamma
        self._law = law
        self._mapping_policy = mapping_policy
        self._configs = configs
        self._batch_sizes = (
            tuple(batch_sizes) if batch_sizes is not None else None
        )
        self._registry = registry
        self._engine_factory = engine_factory
        self._clock = clock
        self._occupancy_window = occupancy_window
        self._engine_kwargs = dict(engine_kwargs or {})
        self._engine_kwargs.setdefault("device", device)
        self.policy = make_policy(policy if policy is not None
                                  else "least_loaded")
        if isinstance(elastic, dict):
            elastic = ElasticController(clock=clock, **elastic)
        self.elastic = elastic
        if store is not None and not isinstance(store, ProfileStore):
            store = ProfileStore(store, device=device)
        self.store = store
        self.cache_hits = 0
        self.cache_misses = 0

        self.plan = place_tenants(
            tenant_plans, n_hosts, gamma=gamma, law=law,
            policy=mapping_policy, configs=configs,
            batch_sizes=self._batch_sizes, registry=registry,
        )
        self.hosts: list = []
        for a in self.plan.assignments:
            host = self._new_host()
            for name in a.tenant_names:
                host.add_tenant(
                    self.tenants[name], self.plan.config_of(name)
                )
            # seed the shared cache with this co-tenancy's joint
            # mappings, so a later scale-up replicating the same
            # resident group warm-starts instead of re-mapping
            if self.store is not None and a.tenant_names:
                self._save_group(
                    {
                        name: self.plan.config_of(name)
                        for name in a.tenant_names
                    }
                )

    # -- shared-cache plumbing ----------------------------------------
    def _group_store(self, names) -> "ProfileStore":
        return self.store.with_scope(fleet_scope(names))

    def _save_group(self, configs_by_name: dict) -> None:
        scoped = self._group_store(tuple(configs_by_name))
        for config in configs_by_name.values():
            scoped.save_mapping(config)

    def _load_group(self, group) -> dict | None:
        """The cached jointly-mapped configurations for exactly this
        resident group, or None unless *every* member has a stored
        mapping that matches its table and the cluster's one serving
        batch size (the hot-swap invariant)."""
        from repro_torch.store import signature_from_labels

        scoped = self._group_store([t.name for t in group])
        out = {}
        for t in group:
            config = scoped.load_mapping_for_labels(
                signature_from_labels(
                    t.table.model_name, t.table.layer_labels
                ),
                policy=self._mapping_policy,
            )
            if (
                config is None
                or config.layer_labels != t.table.layer_labels
                or config.proper_batch_size
                != t.config.proper_batch_size
            ):
                return None
            out[t.name] = config
        return out

    # -- pool plumbing -----------------------------------------------
    def _new_host(self) -> ServingHost:
        host = ServingHost(
            len(self.hosts),
            engine_factory=self._engine_factory,
            clock=self._clock,
            occupancy_window=self._occupancy_window,
            engine_kwargs=self._engine_kwargs,
        )
        self.hosts.append(host)
        return host

    def active_hosts(self) -> list:
        return [h for h in self.hosts if h.status == ACTIVE]

    def _hosts_for(self, tenant: str) -> list:
        return [
            h for h in self.hosts
            if h.accepting and h.hosts_tenant(tenant)
        ]

    def _replicate(self, tp, host: ServingHost) -> None:
        """Add tenant `tp` to `host`, re-mapping the host's resident
        set jointly so existing residents' configurations account for
        their new co-runner.  Residents whose mapping changed are
        batch-boundary hot-swapped (same serving batch size by the
        cluster invariant), never rebuilt.

        With a shared store, a resident group that was jointly mapped
        before (any host, any process over the same backend) loads its
        configurations from the cache instead of re-running the
        mapper; a miss maps and writes back, so the next identical
        scale event hits."""
        group = [self.tenants[n] for n in host.tenant_names()] + [tp]
        by_name = None
        if self.store is not None:
            by_name = self._load_group(group)
            if by_name is not None:
                self.cache_hits += 1
            else:
                self.cache_misses += 1
        if by_name is None:
            plan = map_fleet(
                [t.table for t in group],
                names=[t.name for t in group],
                policy=self._mapping_policy, configs=self._configs,
                batch_sizes=self._batch_sizes,
                weights=[t.weight for t in group],
                gamma=self._gamma, law=self._law,
                registry=self._registry,
            )
            by_name = {t.name: t.config for t in plan.tenants}
            if self.store is not None:
                self._save_group(by_name)
        for name in host.tenant_names():
            engine = host.router.tenant(name).engine
            new = by_name[name]
            # elastic engines route the swap to their full-width slot
            # (a degraded tenant keeps its current level); compare
            # against that slot, not whatever level is serving
            current = (
                engine.level_config(0)
                if hasattr(engine, "level_config") else engine.config
            )
            if new.layer_configs != current.layer_configs:
                engine.swap_configuration(new)
        host.add_tenant(tp, by_name[tp.name])

    # -- scaling hooks (called by ElasticController) -------------------
    def degrade_width(self) -> tuple:
        """Narrow every elastic engine with quality-floor room by one
        subnet level (``repro_torch.elastic``) — the controller's preferred
        move under high water: a width swap is a batch boundary, a new
        host is a topology change.  Returns descriptors of the
        engines narrowed (``tenant@h{id}:L{level}``), empty when no
        floor permits."""
        moved = []
        for h in self.active_hosts():
            for t in h.router.tenants():
                e = t.engine
                if hasattr(e, "set_level") and e.can_degrade():
                    target = e.level + 1
                    e.set_level(target)
                    moved.append(f"{t.name}@h{h.host_id}:L{target}")
        return tuple(moved)

    def restore_width(self) -> tuple:
        """Widen every degraded elastic engine by one subnet level —
        the controller's preferred move under low water: quality debt
        is paid back before capacity is removed.  Returns descriptors
        of the engines widened, empty when none are degraded."""
        moved = []
        for h in self.active_hosts():
            for t in h.router.tenants():
                e = t.engine
                if hasattr(e, "set_level") and e.can_restore():
                    target = e.level - 1
                    e.set_level(target)
                    moved.append(f"{t.name}@h{h.host_id}:L{target}")
        return tuple(moved)

    def scale_up(self) -> tuple:
        """Add a host and replicate the hottest host's residents onto
        it, splitting that host's load.  Returns (host, moved)."""
        donors = self.active_hosts()
        hottest = max(
            donors, key=lambda h: (h.occupancy(), h.pending())
        )
        host = self._new_host()
        moved = []
        for name in hottest.tenant_names():
            self._replicate(self.tenants[name], host)
            moved.append(name)
        if not moved:
            # hottest host was empty (degenerate pool) — replicate
            # every tenant so the new host is immediately useful
            for name, tp in self.tenants.items():
                self._replicate(tp, host)
                moved.append(name)
        return host, tuple(moved)

    def start_drain(self, host: ServingHost) -> tuple:
        """Begin draining `host`.  Tenants whose only accepting
        replica lives there are first replicated onto the least-loaded
        remaining host, so no tenant loses service while the drain
        completes; then every tenant's *queued* (not-yet-dispatched)
        requests migrate to an accepting replica — the draining host
        finishes only what its engines already popped, instead of
        slowly serving a backlog no new capacity can help with.
        Returns the moved tenant names."""
        moved = []
        remaining = [h for h in self.active_hosts() if h is not host]
        if not remaining:
            raise RuntimeError("cannot drain the last active host")
        host.start_drain()
        for name in host.tenant_names():
            if not self._hosts_for(name):
                target = min(
                    remaining, key=lambda h: (h.pending(), h.host_id)
                )
                self._replicate(self.tenants[name], target)
                moved.append(name)
        # hand off the queued backlog (dispatched batches stay — they
        # complete bit-exact on the engines that popped them)
        for name in host.tenant_names():
            replicas = self._hosts_for(name)
            if not replicas:
                continue
            target = min(
                replicas, key=lambda h: (h.pending(), h.host_id)
            )
            host.migrate_queued(name, target)
        return tuple(moved)

    def on_retired(self, host: ServingHost) -> None:
        """Post-retire hook (journaled by the controller)."""

    # -- serving -----------------------------------------------------
    def submit(self, tenant: str, x, *, key=None):
        """Route one request to a replica of `tenant` (dispatch
        policy picks among accepting hosts)."""
        if tenant not in self.tenants:
            raise KeyError(f"unknown tenant {tenant!r}")
        host = self.policy.choose(self._hosts_for(tenant), tenant, key)
        return host.submit(tenant, x)

    def step(self, *, force: bool = False) -> dict:
        """One cluster tick: every non-retired host takes a dispatch
        round, then the elastic controller (when attached) takes a
        control tick.  Returns {tenant: served} aggregated."""
        served: dict = {}
        for h in self.hosts:
            if h.status == RETIRED:
                continue
            for name, n in h.step(force=force).items():
                served[name] = served.get(name, 0) + n
        if self.elastic is not None:
            self.elastic.observe(self)
        return served

    def drain(self, *, max_steps: int = 1000) -> dict:
        """Force-serve until every host's queues are empty."""
        total: dict = {}
        for h in self.hosts:
            if h.status == RETIRED:
                continue
            for name, n in h.drain(max_steps=max_steps).items():
                total[name] = total.get(name, 0) + n
        return total

    def pending(self) -> int:
        return sum(
            h.pending() for h in self.hosts if h.status != RETIRED
        )

    def stats(self) -> dict:
        out = {
            "mode": "cluster",
            "n_hosts": len(self.hosts),
            "n_active": len(self.active_hosts()),
            "plan": self.plan.to_dict(),
            "hosts": [h.stats() for h in self.hosts],
        }
        if self.elastic is not None:
            out["elastic"] = [
                r.to_dict() for r in self.elastic.journal
            ]
        if self.store is not None:
            out["cache"] = {
                "hits": self.cache_hits,
                "misses": self.cache_misses,
                "backend": self.store.stats(),
            }
        return out
