"""The blessed path through the stack: profile → map → fuse → place
→ serve, behind one facade.

The stack has many entry points (profiler sweeps, two mappers, the
fusion pass, engines, routers, the cluster tier); this module is the
single public API over them, the port of the JAX package's
``repro.api``:

* **Canonical verb set** (re-exported, one name per verb)::

      profile_model    fixed-space per-layer sweep (paper §IV)
      autotune_model   registry-driven sweep with pruning
      map_model        single-model greedy/DP mapping
      map_fleet        contention-aware joint mapping
      map_all_device   DP restricted to device placements
      price_mapping    price an explicit per-layer mapping
      fuse_mapping     profile + select fused segment kernels

  The pre-facade spellings (``configuration_from_mapping``,
  ``fuse_configuration``, ``all_device_configuration``) remain
  importable from their home modules as deprecation shims that
  delegate here (one warning per call site).

* **Devices.**  Every entry point that profiles or serves takes
  ``device``: ``None`` means ``cuda`` (and raises without a card),
  ``"cpu"`` runs every layer on CPU tensors.  It reaches the profiler,
  the fusion pass, the engines and the store's fingerprint.

* **Planning helpers** — :func:`plan_single` / :func:`plan_fleet`
  run the profile→map(→fuse) chain for one model or a co-served
  fleet, store-aware (zero profiling passes on a warm start).

* **:class:`Deployment`** — the one object consumers hold::

      dep = Deployment.plan({"a": (model_a, packed_a),
                             "b": (model_b, packed_b)},
                            hosts=2, batch_sizes=(4,), store=store)
      dep.serve()
      req = dep.submit(x, tenant="a")
      dep.step(); dep.drain()
      dep.stats()

  ``plan()`` picks the serving topology from its inputs: one model on
  one host serves through a
  :class:`~repro_torch.serving.ServingEngine`; several models on one
  host through a :class:`~repro_torch.fleet.FleetRouter` (+ ledger,
  optional per-tenant adaptive controllers); ``hosts > 1`` stands up
  the cluster tier (:mod:`repro_torch.cluster`): tenant placement,
  per-host routers, a pluggable dispatch policy, and optionally an
  elastic host pool.  The hosts are logical: in one process they
  share its CPU and its card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.mapper import (
    EfficientConfiguration,
    map_efficient_configuration,
    price_mapping,
)
from repro_torch.core.plan import fuse_mapping
from repro_torch.core.profiler import (
    ProfileTable,
    autotune_bnn_model,
    profile_bnn_model,
)
from repro_torch.fleet.scheduler import FleetPlan, map_all_device, map_fleet

__all__ = [
    # the verb set: profile, map, price, fuse
    "profile_model",
    "autotune_model",
    "map_model",
    "map_fleet",
    "map_all_device",
    "price_mapping",
    "fuse_mapping",
    # planning + serving facade
    "plan_single",
    "plan_fleet",
    "Deployment",
    "TenantPlan",
    # the objects plans are made of
    "ProfileTable",
    "EfficientConfiguration",
    "FleetPlan",
]

# verb-set aliases: the implementations keep their paper-faithful
# homes; the facade fixes the public names
profile_model = profile_bnn_model
autotune_model = autotune_bnn_model
map_model = map_efficient_configuration


@dataclasses.dataclass
class TenantPlan:
    """One planned tenant: everything needed to build its engine.

    ``elastic`` (an :class:`~repro_torch.elastic.ElasticPlan`, set by
    ``Deployment.plan(elastic=...)``) carries the tenant's planned
    nested-width subnet levels; its level 0 is this plan.
    ``quality_floor`` is the deepest subnet level the tenant may be
    degraded to (``None`` = the narrowest planned level; 0 pins full
    width)."""

    name: str
    model: object
    packed: list
    table: ProfileTable
    config: EfficientConfiguration
    weight: float = 1.0
    priority: int = 0
    deadline_s: float = math.inf
    elastic: object = None
    quality_floor: int | None = None

    @property
    def expected_s_per_example(self) -> float:
        return self.config.expected_time_per_example


def _as_store(store, device=None):
    """Normalize a ``store=`` argument: None passes through, a
    :class:`~repro_torch.store.ProfileStore` is used as-is, and anything
    else — a root path, a ``dir://`` / ``sqlite://`` / ``mem://``
    backend URI, or a :class:`~repro_torch.cachesvc.StoreBackend` — becomes
    a store over that backend, keyed by `device`'s fingerprint
    (``None`` -> ``cuda``).  This is how ``plan(store=...)`` accepts
    cache-service URIs everywhere a store object worked."""
    if store is None:
        return None
    from repro_torch.store import ProfileStore

    if isinstance(store, ProfileStore):
        return store
    return ProfileStore(store, device=device)


def _profile_fn(*, autotune, configs, repeats, time_source, registry,
                device=None):
    """The profiling callable plan_* hand to the store's
    ``get_or_profile`` (signature: model, packed, batch_sizes=...)."""
    if autotune:
        def fn(model, packed, *, batch_sizes):
            return autotune_model(
                model, packed, batch_sizes=batch_sizes,
                repeats=repeats, time_source=time_source,
                registry=registry, device=device,
            )
    else:
        def fn(model, packed, *, batch_sizes):
            kwargs = {} if configs is None else {"configs": configs}
            return profile_model(
                model, packed, batch_sizes=batch_sizes,
                repeats=repeats, time_source=time_source,
                device=device, **kwargs,
            )
    return fn


def plan_single(
    model,
    packed,
    *,
    batch_sizes: Sequence[int] = (1, 4, 16),
    store=None,
    policy: str = "dp",
    configs: Sequence[str] | None = None,
    autotune: bool = False,
    fuse: bool = False,
    repeats: int = 2,
    time_source: str = "measured",
    registry=None,
    name: str | None = None,
    device=None,
) -> TenantPlan:
    """Profile → map (→ fuse) one model; the single-tenant planning
    path every consumer shares.

    With a :class:`~repro_torch.store.ProfileStore`, a stored profile is a
    warm start (zero profiling passes) and the resulting mapping is
    persisted back.  ``autotune=True`` sweeps the open registry space
    instead of the fixed 8; ``fuse=True`` additionally profiles
    segment-scope variants over the mapping's device segments and
    records the winners (:func:`fuse_mapping`).  Measured sweeps run
    on `device` (``None`` -> ``cuda``)."""
    store = _as_store(store, device=device)
    profile = _profile_fn(
        autotune=autotune, configs=configs, repeats=repeats,
        time_source=time_source, registry=registry, device=device,
    )
    if store is not None:
        table, _ = store.get_or_profile(
            model, packed, profile, batch_sizes=batch_sizes
        )
    else:
        table = profile(model, packed, batch_sizes=batch_sizes)
    config = map_model(table, policy=policy, configs=configs)
    if fuse:
        config = fuse_mapping(
            model, packed, table, config,
            registry=registry, time_source=time_source, repeats=repeats,
            device=device,
        )
        if store is not None:
            store.save_profile(table)   # now carries the segment rows
    if store is not None:
        store.save_mapping(config)
    return TenantPlan(
        name=name or getattr(model, "name", table.model_name),
        model=model, packed=packed, table=table, config=config,
    )


def plan_fleet(
    models: dict,
    *,
    batch_sizes: Sequence[int] = (4,),
    store=None,
    policy: str = "dp",
    configs: Sequence[str] | None = None,
    autotune: bool = False,
    repeats: int = 2,
    time_source: str = "measured",
    registry=None,
    gamma: float = 1.0,
    law=None,
    weights: dict | None = None,
    shares=None,
    device=None,
) -> tuple:
    """Profile every tenant and jointly map the fleet under the
    contention model (:func:`map_fleet`).

    `models` is ``{name: (model, packed_params)}``; `weights` an
    optional ``{name: relative workload}``.  Returns ``(tenants,
    fleet_plan)`` where `tenants` is a name-keyed dict of
    :class:`TenantPlan` carrying each tenant's contention-priced
    configuration.  With a store, profiles warm-start and the joint
    mappings are persisted (callers co-serving should hand a
    fleet-scoped store — ``ProfileStore(root,
    scope=fleet_scope(names))`` — so joint mappings never leak into
    solo deployments).  Measured sweeps run on `device` (``None`` ->
    ``cuda``)."""
    if not models:
        raise ValueError("plan_fleet needs at least one tenant")
    store = _as_store(store, device=device)
    names = tuple(models)
    profile = _profile_fn(
        autotune=autotune, configs=configs, repeats=repeats,
        time_source=time_source, registry=registry, device=device,
    )
    tables = []
    for name in names:
        model, packed = models[name]
        if store is not None:
            table, _ = store.get_or_profile(
                model, packed, profile, batch_sizes=batch_sizes
            )
        else:
            table = profile(model, packed, batch_sizes=batch_sizes)
        tables.append(table)
    weight_seq = (
        None if weights is None
        else tuple(float(weights.get(n, 1.0)) for n in names)
    )
    plan = map_fleet(
        tables, names=names, policy=policy, configs=configs,
        batch_sizes=tuple(batch_sizes), weights=weight_seq,
        shares=shares, gamma=gamma, law=law, registry=registry,
    )
    tenants = {}
    for name, table, tp in zip(names, tables, plan.tenants):
        model, packed = models[name]
        tenants[name] = TenantPlan(
            name=name, model=model, packed=packed, table=table,
            config=tp.config, weight=tp.weight,
        )
        if store is not None:
            store.save_mapping(tp.config)
    return tenants, plan


def _as_model_dict(models) -> dict:
    """Normalize ``plan()``'s `models` argument: a single ``(model,
    packed)`` pair or a ``{name: (model, packed)}`` dict."""
    if isinstance(models, dict):
        if not models:
            raise ValueError("models dict must not be empty")
        return dict(models)
    model, packed = models
    name = getattr(model, "name", "model")
    return {name: (model, packed)}


def _as_elastic_specs(elastic, names) -> dict:
    """Normalize ``plan()``'s `elastic` argument to {name:
    ElasticSpec}: ``None`` (no elastic tenants), one spec or fractions
    tuple (applied to every tenant), or a per-tenant dict of either."""
    if elastic is None:
        return {}
    from repro_torch.elastic import ElasticSpec

    def as_spec(v):
        if isinstance(v, ElasticSpec):
            return v
        return ElasticSpec(fractions=tuple(v))

    if isinstance(elastic, dict):
        unknown = set(elastic) - set(names)
        if unknown:
            raise ValueError(
                f"elastic names {sorted(unknown)} match no tenant in "
                f"{sorted(names)}"
            )
        return {n: as_spec(v) for n, v in elastic.items()}
    spec = as_spec(elastic)
    return {n: spec for n in names}


class Deployment:
    """A planned (and, after :meth:`serve`, running) deployment —
    the one object the examples, benchmarks and cluster tier hold.

    Build via :meth:`plan`; every knob of the underlying chain
    (policy, configs, autotune, fuse, gamma/law, priorities,
    deadlines, hosts, routing) is a keyword here so no consumer needs
    the internals."""

    def __init__(self, *, tenants, fleet_plan=None, hosts=1, **knobs):
        self.tenants: dict = tenants            # name -> TenantPlan
        self.fleet_plan = fleet_plan            # FleetPlan | None
        self.hosts = int(hosts)
        self._knobs = knobs
        # serving state (populated by serve())
        self.engine = None                      # single-tenant mode
        self.router = None                      # fleet mode
        self.ledger = None
        self.controllers: dict = {}
        self.cluster = None                     # cluster mode
        self.cluster_plan = None

    # -- planning ----------------------------------------------------
    @classmethod
    def plan(
        cls,
        models,
        *,
        hosts: int = 1,
        store=None,
        batch_sizes: Sequence[int] = (4,),
        policy: str = "dp",
        configs: Sequence[str] | None = None,
        autotune: bool = False,
        fuse: bool = False,
        repeats: int = 2,
        time_source: str = "measured",
        registry=None,
        gamma: float = 1.0,
        law=None,
        weights: dict | None = None,
        priorities: dict | None = None,
        deadlines: dict | None = None,
        routing: str = "least_loaded",
        elastic=None,
        quality_floors: dict | None = None,
        estimate_levels: bool = False,
        device=None,
    ) -> "Deployment":
        """Plan `models` onto `hosts` logical serving hosts.

        One model, one host → single-engine deployment (optionally
        ``fuse``\\ d).  Several models, one host → joint fleet mapping.
        ``hosts > 1`` → the cluster placement scheduler assigns
        tenants to hosts and each host plans its own fleet (the
        per-host mapping happens at :meth:`serve`, against the actual
        co-residents placement chose).

        ``elastic`` declares nested-width subnet families
        (``repro_torch.elastic``): an ``ElasticSpec``, a fractions tuple
        like ``(1.0, 0.5, 0.25)``, or a per-tenant dict of either.
        Elastic tenants get every level planned (level-tagged store
        keys; level 0 is the tenant's own plan) and serve through an
        ``ElasticEngine``.  ``quality_floors`` is ``{name: deepest
        permitted level}``; ``estimate_levels=True`` prices narrow
        levels through the store's persisted latency predictor when
        one exists (zero extra profiling sweeps).  Note the distinct
        ``serve(elastic=...)`` knob, which configures the cluster
        host-pool controller.  `device` (``None`` -> ``cuda``) is where
        profiles are measured and, at :meth:`serve`, where every engine
        serves."""
        if hosts < 1:
            raise ValueError("hosts must be >= 1")
        store = _as_store(store, device=device)
        model_dict = _as_model_dict(models)
        single = len(model_dict) == 1 and hosts == 1
        if single:
            ((name, (model, packed)),) = model_dict.items()
            tp = plan_single(
                model, packed, batch_sizes=batch_sizes, store=store,
                policy=policy, configs=configs, autotune=autotune,
                fuse=fuse, repeats=repeats, time_source=time_source,
                registry=registry, name=name, device=device,
            )
            tenants, fleet_plan = {tp.name: tp}, None
        elif hosts == 1:
            tenants, fleet_plan = plan_fleet(
                model_dict, batch_sizes=batch_sizes, store=store,
                policy=policy, configs=configs, autotune=autotune,
                repeats=repeats, time_source=time_source,
                registry=registry, gamma=gamma, law=law,
                weights=weights, device=device,
            )
        else:
            # cluster mode: profile every tenant now (store-aware);
            # placement + per-host joint mapping happen in serve()
            profile = _profile_fn(
                autotune=autotune, configs=configs, repeats=repeats,
                time_source=time_source, registry=registry, device=device,
            )
            tenants = {}
            for name, (model, packed) in model_dict.items():
                if store is not None:
                    table, _ = store.get_or_profile(
                        model, packed, profile, batch_sizes=batch_sizes
                    )
                else:
                    table = profile(model, packed, batch_sizes=batch_sizes)
                tenants[name] = TenantPlan(
                    name=name, model=model, packed=packed,
                    table=table,
                    config=map_model(
                        table, policy=policy, configs=configs
                    ),
                )
            fleet_plan = None
        for name, tp in tenants.items():
            tp.weight = float((weights or {}).get(name, tp.weight))
            tp.priority = int((priorities or {}).get(name, 0))
            tp.deadline_s = float((deadlines or {}).get(name, math.inf))
        elastic_specs = _as_elastic_specs(elastic, tuple(tenants))
        for name, spec in elastic_specs.items():
            from repro_torch.elastic import SubnetFamily, plan_family

            tp = tenants[name]
            family = SubnetFamily.build(tp.model, tp.packed, spec)
            # base=tp: level 0 reuses this tenant's (solo or joint)
            # plan verbatim; narrow levels are planned under their
            # #L{k}-tagged store keys
            tp.elastic = plan_family(
                family, base=tp, store=store, policy=policy,
                configs=configs, autotune=autotune, repeats=repeats,
                time_source=time_source, registry=registry,
                estimate=estimate_levels, device=device,
            )
            if quality_floors and name in quality_floors:
                tp.quality_floor = int(quality_floors[name])
        return cls(
            tenants=tenants, fleet_plan=fleet_plan, hosts=hosts,
            store=store, policy=policy, configs=configs, gamma=gamma,
            law=law, registry=registry, routing=routing,
            batch_sizes=tuple(batch_sizes), device=device,
        )

    # -- serving -----------------------------------------------------
    @property
    def mode(self) -> str:
        if self.hosts > 1:
            return "cluster"
        return "single" if len(self.tenants) == 1 else "fleet"

    def configuration(self, name: str | None = None):
        """The planned :class:`EfficientConfiguration` for `name`
        (or the only tenant's when omitted)."""
        if name is None:
            if len(self.tenants) != 1:
                raise ValueError(
                    f"deployment has tenants {tuple(self.tenants)}; "
                    "name one"
                )
            (tp,) = self.tenants.values()
            return tp.config
        return self.tenants[name].config

    def serve(
        self,
        *,
        adapt: bool = False,
        telemetry_sample_every: int = 2,
        engine_factory=None,
        elastic=None,
        quality=None,
        clock=None,
        **engine_kwargs,
    ) -> "Deployment":
        """Stand up the serving tier for the planned topology and
        return self.

        ``adapt=True`` attaches per-tenant ``SegmentTelemetry`` + a
        ``RemapController`` (journaled drift-triggered remapping)
        in single/fleet modes.  ``engine_factory(tenant_plan, config,
        **kwargs)`` overrides engine construction (benchmarks inject
        contention-taxed engines).  ``elastic`` is a dict of
        :class:`repro_torch.cluster.ElasticController` knobs (cluster mode
        only; ``None`` serves a fixed pool).  ``quality`` (fleet mode)
        attaches a :class:`~repro_torch.fleet.QualityController` that
        degrades/restores elastic tenants' subnet width on shed
        pressure: ``True`` for defaults, a knob dict, or a built
        controller.  Extra ``engine_kwargs`` (e.g. ``max_wait_s``)
        reach every engine; engines serve on the planned ``device``
        unless ``engine_kwargs`` names another."""
        engine_kwargs.setdefault("device", self._knobs.get("device"))
        if quality is not None and self.mode != "fleet":
            raise ValueError(
                "quality= drives width adaptation off the fleet "
                "router's admission signal; in cluster mode attach "
                "the host-pool controller (serve(elastic=...)) — it "
                "prefers width degradation — and in single mode call "
                "engine.set_level() directly"
            )
        if self.mode == "cluster":
            from repro_torch.cluster import Cluster, make_policy

            self.cluster = Cluster(
                tuple(self.tenants.values()),
                n_hosts=self.hosts,
                gamma=self._knobs.get("gamma", 1.0),
                law=self._knobs.get("law"),
                configs=self._knobs.get("configs"),
                batch_sizes=self._knobs.get("batch_sizes"),
                registry=self._knobs.get("registry"),
                policy=make_policy(self._knobs.get("routing",
                                                   "least_loaded")),
                engine_factory=engine_factory,
                elastic=elastic,
                store=self._knobs.get("store"),
                **({} if clock is None else {"clock": clock}),
                engine_kwargs=engine_kwargs,
                device=engine_kwargs["device"],
            )
            self.cluster_plan = self.cluster.plan
            return self

        if self.mode == "fleet":
            from repro_torch.fleet import DeviceTimeLedger, FleetRouter

            self.ledger = DeviceTimeLedger()
            self.router = FleetRouter(
                ledger=self.ledger, quality=self._as_quality(quality)
            )
        for name, tp in self.tenants.items():
            observer = (
                self.ledger.observer(name) if self.ledger is not None
                else None
            )
            telemetry = None
            if adapt:
                from repro_torch.adapt import SegmentTelemetry

                telemetry = SegmentTelemetry(
                    sample_every=telemetry_sample_every, tenant=name
                )
            engine = self._build_engine(
                tp, engine_factory, telemetry=telemetry,
                observer=observer, **engine_kwargs,
            )
            controller = None
            if adapt:
                from repro_torch.adapt import RemapController

                controller = RemapController(
                    engine, tp.table, store=self._knobs.get("store"),
                    tenant=name,
                )
                self.controllers[name] = controller
            if self.mode == "single":
                self.engine = engine
            else:
                self.router.add_tenant(
                    name, engine, priority=tp.priority,
                    deadline_s=tp.deadline_s, controller=controller,
                )
        return self

    @staticmethod
    def _as_quality(quality):
        if quality is None or quality is False:
            return None
        from repro_torch.fleet import QualityController

        if isinstance(quality, QualityController):
            return quality
        if quality is True:
            return QualityController()
        return QualityController(**quality)

    @staticmethod
    def _build_engine(tp: TenantPlan, factory, **kwargs):
        kwargs.setdefault("allowed_batch_sizes", tp.table.batch_sizes)
        if factory is not None:
            return factory(tp, tp.config, **kwargs)
        if tp.elastic is not None:
            from repro_torch.elastic import ElasticEngine

            return ElasticEngine(
                tp.elastic, quality_floor=tp.quality_floor, **kwargs
            )
        from repro_torch.serving import ServingEngine

        return ServingEngine(tp.model, tp.packed, tp.config, **kwargs)

    def _serving(self):
        target = self.engine or self.router or self.cluster
        if target is None:
            raise RuntimeError(
                "deployment is planned but not serving; call serve()"
            )
        return target

    def submit(self, x, *, tenant: str | None = None, key=None):
        """Enqueue one example.  `tenant` is required except in
        single-tenant mode; `key` is the affinity key consistent-hash
        cluster routing uses (ignored elsewhere)."""
        target = self._serving()
        if self.engine is not None:
            return self.engine.submit(x)
        if tenant is None:
            raise ValueError("tenant= is required for multi-tenant "
                             "deployments")
        if self.router is not None:
            return self.router.submit(tenant, x)
        return target.submit(tenant, x, key=key)

    def step(self, *, force: bool = False):
        return self._serving().step(force=force)

    def drain(self, **kwargs):
        target = self._serving()
        if self.engine is not None:
            served = 0
            while self.engine.batcher.pending():
                served += self.engine.step(force=True)
            return served
        return target.drain(**kwargs)

    def stats(self) -> dict:
        """One nested dict for the whole deployment — per-tenant
        admission/served counters, ledger occupancy where metered,
        and per-host pool state in cluster mode."""
        if self.cluster is not None:
            return self.cluster.stats()
        if self.router is not None:
            out = {"mode": "fleet", "tenants": self.router.stats()}
            if self.ledger is not None:
                out["ledger"] = self.ledger.snapshot()
            if self.router.quality is not None:
                out["quality"] = [
                    dataclasses.asdict(r)
                    for r in self.router.quality.journal
                ]
            return out
        e = self._serving()
        out = {
            "mode": "single",
            "served": e.served,
            "steps": e.steps,
            "swaps": e.swaps,
        }
        if hasattr(e, "set_level"):
            out.update(
                level=e.level,
                quality_floor=e.quality_floor,
                level_switches=e.level_switches,
                degraded_share=e.degraded_share,
            )
        return out
