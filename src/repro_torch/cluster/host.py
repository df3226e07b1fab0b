"""One logical serving host: a full co-serving stack (per-tenant
engines behind a :class:`~repro_torch.fleet.FleetRouter`, occupancy
metered by a :class:`~repro_torch.fleet.DeviceTimeLedger`) plus the
lifecycle the cluster tier needs — ``ACTIVE`` hosts take new
requests, ``DRAINING`` hosts finish what they already admitted
(bit-exact — a drain never drops or re-routes an in-flight batch),
``RETIRED`` hosts are empty shells the pool forgets.

Hosts in one process model machines in a cluster: the placement
prices each as its own CPU + card pair, so cross-host contention is
zero in the model and the cluster's makespan is the max over hosts,
not the sum.  In one process they share that process's CPU and card.
"""

from __future__ import annotations

import math
import time
from collections import deque

from repro_torch.fleet.ledger import DeviceTimeLedger
from repro_torch.fleet.router import FleetRouter

ACTIVE = "active"
DRAINING = "draining"
RETIRED = "retired"


class ServingHost:
    """One host of the pool.  Build engines through
    ``engine_factory(tenant_plan, config, **kwargs)`` (defaults to a
    plain :class:`~repro_torch.serving.ServingEngine`) so benchmarks can
    inject contention-taxed engines without subclassing the host.
    ``engine_kwargs`` reach every engine, ``device`` among them."""

    def __init__(
        self,
        host_id: int,
        *,
        engine_factory=None,
        clock=time.monotonic,
        occupancy_window: int = 16,
        engine_kwargs: dict | None = None,
    ):
        if occupancy_window < 1:
            raise ValueError("occupancy_window must be >= 1")
        self.host_id = host_id
        self.status = ACTIVE
        self.ledger = DeviceTimeLedger()
        self.router = FleetRouter(ledger=self.ledger)
        self._engine_factory = engine_factory
        self._clock = clock
        self._engine_kwargs = dict(engine_kwargs or {})
        self.occupancy_window = int(occupancy_window)
        # 1.0/0.0 per dispatch round (served work / sat idle) — the
        # windowed busy-fraction the elastic controller watches.
        # Round-windowed rather than wall-time-windowed: logical
        # hosts share one process clock, so a host's wall window
        # includes its peers' serving time and a time-based fraction
        # would cap at 1/n_hosts even under saturation
        self._busy: deque = deque(maxlen=self.occupancy_window)
        self.tenant_plans: dict = {}   # name -> TenantPlan

    # -- tenancy -----------------------------------------------------
    def add_tenant(self, tp, config, **router_kwargs) -> None:
        """Stand up an engine for `tp` under `config` (the host-local
        jointly-mapped configuration) and register it."""
        if self.status != ACTIVE:
            raise RuntimeError(
                f"host {self.host_id} is {self.status}; cannot add "
                f"tenant {tp.name!r}"
            )
        kwargs = dict(self._engine_kwargs)
        kwargs.setdefault("allowed_batch_sizes", tp.table.batch_sizes)
        kwargs["observer"] = self.ledger.observer(tp.name)
        elastic_plan = getattr(tp, "elastic", None)
        if self._engine_factory is not None:
            engine = self._engine_factory(tp, config, **kwargs)
        elif elastic_plan is not None:
            # elastic tenant: all subnet levels resident, the joint
            # host-local mapping serving as level 0's configuration
            from repro_torch.elastic import ElasticEngine

            engine = ElasticEngine(
                elastic_plan, config=config,
                quality_floor=getattr(tp, "quality_floor", None),
                **kwargs,
            )
        else:
            from repro_torch.serving import ServingEngine

            engine = ServingEngine(tp.model, tp.packed, config, **kwargs)
        router_kwargs.setdefault("priority", tp.priority)
        router_kwargs.setdefault("deadline_s", tp.deadline_s)
        self.router.add_tenant(tp.name, engine, **router_kwargs)
        self.tenant_plans[tp.name] = tp

    def tenant_names(self) -> tuple:
        return tuple(self.tenant_plans)

    def hosts_tenant(self, name: str) -> bool:
        return name in self.tenant_plans

    # -- serving -----------------------------------------------------
    @property
    def accepting(self) -> bool:
        return self.status == ACTIVE

    def submit(self, tenant: str, x):
        if not self.accepting:
            raise RuntimeError(
                f"host {self.host_id} is {self.status}; dispatch must "
                "not route new requests here"
            )
        return self.router.submit(tenant, x)

    def pending(self) -> int:
        """Requests queued across every tenant on this host."""
        return sum(
            t.engine.batcher.pending() for t in self.router.tenants()
        )

    def migrate_queued(self, tenant: str, target: "ServingHost") -> int:
        """Hand `tenant`'s *queued* (admitted but not yet dispatched)
        requests to `target`'s replica of the same tenant — the drain
        hand-off path: requests an engine already popped still finish
        here (bit-exact, never re-routed mid-batch), but work nothing
        has started moves to a host that is still accepting.  Returns
        requests moved."""
        if not target.hosts_tenant(tenant):
            raise ValueError(
                f"host {target.host_id} has no replica of {tenant!r}"
            )
        src = self.router.tenant(tenant).engine.batcher
        dst = target.router.tenant(tenant).engine.batcher
        return src.migrate_to(dst)

    def step(self, *, force: bool = False) -> dict:
        """One router dispatch round, busy-metered for occupancy."""
        served = self.router.step(force=force)
        self._busy.append(1.0 if served else 0.0)
        return served

    def drain(self, *, max_steps: int = 1000) -> dict:
        """Forced steps until every queue is empty.  In-flight
        requests complete on this host's engines — draining changes
        *where new work goes*, never *how admitted work executes*."""
        total: dict = {}
        for _ in range(max_steps):
            served = self.step(force=True)
            if not served:
                break
            for name, n in served.items():
                total[name] = total.get(name, 0) + n
        return total

    # -- lifecycle ---------------------------------------------------
    def start_drain(self) -> None:
        if self.status == ACTIVE:
            self.status = DRAINING

    def retire(self) -> None:
        """Finalize a drained host.  Refuses while work is in flight:
        the drain-then-retire order is the bit-exactness guarantee."""
        if self.pending():
            raise RuntimeError(
                f"host {self.host_id} still has {self.pending()} "
                "in-flight requests; drain before retiring"
            )
        self.status = RETIRED

    # -- telemetry ---------------------------------------------------
    def occupancy(self) -> float:
        """Busy fraction over the trailing ``occupancy_window``
        dispatch rounds: 1.0 means every recent round served work, 0.0
        means the host sat idle.  A young host reads its (short)
        actual history, so a freshly-added host under load registers
        hot immediately."""
        if not self._busy:
            return 0.0
        return sum(self._busy) / len(self._busy)

    def stats(self) -> dict:
        return {
            "host_id": self.host_id,
            "status": self.status,
            "pending": self.pending(),
            "occupancy": self.occupancy(),
            "tenants": self.router.stats(),
            "ledger": self.ledger.snapshot(),
        }


def latency_quantile(samples, q: float) -> float:
    """Nearest-rank quantile (q in [0, 1]) of `samples` — the p99
    helper cluster benchmarks and isolation assertions share."""
    if not samples:
        return 0.0
    xs = sorted(samples)
    k = min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))
    return xs[k]
