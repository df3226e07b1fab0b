"""SLO-aware request routing over per-tenant serving engines.

:class:`FleetRouter` fronts N tenants, each a
:class:`~repro_torch.serving.ServingEngine` (its ``MicroBatcher`` is the
tenant's queue) with a priority, a latency deadline, and optionally a
per-tenant :class:`~repro_torch.adapt.RemapController`:

* **submit** — admission control at the door: a request predicted to
  complete past its tenant's deadline (queue depth ahead of it, in
  batches, times the tenant's expected step time — the **live**
  telemetry estimate once the engine's ``SegmentTelemetry`` is warm,
  the profiled prediction while cold) is *rejected now*
  rather than served late — a shed request costs nothing, a late one
  cost a batch slot some other tenant's in-SLO request needed.
  Rejections are counted per tenant (:meth:`stats`).
* **step** — dispatch: tenants with a ready batch are served in
  (higher priority first, earliest deadline first) order, one engine
  step each — strict priority, rather than fair-share, because the
  joint mapper already balanced sustained load; priority here decides
  who eats a transient burst's latency.  Tenants with an attached
  controller are stepped through it, so per-tenant drift detection
  and remapping ride the same dispatch loop.  When a
  :class:`~repro_torch.fleet.ledger.DeviceTimeLedger` is attached, every
  tenant's engine observer feeds it and the router closes the
  tenant's ledger step after each dispatch.

* **quality** — when a :class:`QualityController` is attached, the
  router closes every dispatch round by letting it observe shed
  pressure and hot-swap elastic tenants' engines to a narrower subnet
  level before the next round sheds more (``repro_torch.elastic``) —
  degrading width instead of availability, and restoring width when
  the pressure clears.

Threading contract (see ``repro_torch.serving.batcher``): ``submit`` may be
called from many client threads concurrently; ``step`` must be driven
from a single dispatch thread.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time

from repro_torch.serving.batcher import Request
from repro_torch.serving.engine import ServingEngine


@dataclasses.dataclass
class Tenant:
    """One co-served model behind the router."""

    name: str
    engine: ServingEngine
    priority: int = 0             # higher dispatches first
    deadline_s: float = math.inf  # per-request latency SLO
    controller: object = None     # optional RemapController
    # samples every segment needs before live telemetry replaces the
    # profiled step estimate in admission
    live_min_samples: int = 3
    admitted: int = 0
    rejected: int = 0
    # guards this tenant's admission decision + counters: submit() is
    # callable from many client threads, and an unlocked
    # `admitted += 1` loses increments under thread switches.
    # Per-tenant, so one tenant's submit storm never serializes
    # another tenant's clients
    lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False
    )

    def live_step_s(self) -> float | None:
        """Measured wall seconds for one full engine step, from the
        engine's segment-telemetry EWMAs — or ``None`` while cold
        (no telemetry attached, or any segment below
        ``live_min_samples``).  Hot swaps reset the telemetry, so the
        estimate automatically falls back to profiled until the new
        configuration has been observed."""
        telemetry = getattr(self.engine, "telemetry", None)
        if telemetry is None:
            return None
        cfg = self.engine.config
        s_ex = telemetry.live_s_per_example(
            len(cfg.segments()), min_count=self.live_min_samples
        )
        if s_ex is None:
            return None
        return s_ex * cfg.proper_batch_size

    def step_expected_s(self) -> float:
        """Expected wall seconds for one full engine step — one
        micro-batch of the serving batch size under the tenant's
        current configuration.  Prefers the live telemetry estimate
        (:meth:`live_step_s`) so admission tracks what the step
        actually costs under drift; falls back to the profiled
        prediction while telemetry is cold (hot swaps update both
        paths automatically because the engine's config is read
        live)."""
        live = self.live_step_s()
        if live is not None:
            return live
        cfg = self.engine.config
        return cfg.expected_time_per_example * cfg.proper_batch_size

    def backlog_batches(self, extra: int = 1) -> int:
        """Batches ahead of (and including) a request arriving now."""
        pending = self.engine.batcher.pending() + extra
        return math.ceil(pending / self.engine.batcher.max_batch)


@dataclasses.dataclass(frozen=True)
class QualityRecord:
    """One journaled quality transition — the elastic analogue of
    ``SwapRecord`` (remaps) and ``ScaleRecord`` (topology)."""

    seq: int
    at_s: float
    tenant: str
    action: str          # "degrade" | "restore" | "floor_hold"
    from_level: int
    to_level: int
    reason: str
    shed_delta: int      # rejections since the previous observation
    backlog_batches: int
    est_step_s: float
    deadline_s: float
    applied: bool        # False when deferred to the batch boundary


class QualityController:
    """SLO-driven width adaptation for elastic tenants.

    Watches each elastic tenant's *shed pressure* — the delta of its
    rejection counter between dispatch rounds (admission control
    already encodes backlog × step-estimate vs deadline, so a shed is
    the precise signal that the current width cannot hold the SLO) —
    and drives the engine's subnet level with drift-style hysteresis:

    * ``degrade_after`` consecutive rounds with sheds → hot-swap one
      level narrower (``engine.set_level(level + 1)``), *before* the
      next round sheds more.  At the engine's ``quality_floor`` a
      ``floor_hold`` is journaled instead — the floor is honored, the
      overflow sheds.
    * ``restore_after`` consecutive shed-free rounds → one level wider,
      but only when the wider level's expected step fits inside
      ``headroom × deadline`` (restoring into a step that instantly
      sheds again would oscillate).

    Every transition (and every held floor) is a :class:`QualityRecord`
    in :attr:`journal`.  Attach via ``FleetRouter(quality=...)`` — the
    router calls :meth:`observe` at the end of each dispatch round —
    or call :meth:`observe` from your own loop.
    """

    def __init__(
        self,
        *,
        degrade_after: int = 2,
        restore_after: int = 4,
        headroom: float = 0.5,
        clock=time.monotonic,
    ):
        if degrade_after < 1 or restore_after < 1:
            raise ValueError(
                "degrade_after and restore_after must be >= 1"
            )
        if not 0.0 < headroom <= 1.0:
            raise ValueError("headroom must be in (0, 1]")
        self.degrade_after = degrade_after
        self.restore_after = restore_after
        self.headroom = headroom
        self._clock = clock
        self.journal: list[QualityRecord] = []
        self._seq = 0
        self._last_rejected: dict[str, int] = {}
        self._hi: dict[str, int] = {}
        self._lo: dict[str, int] = {}

    @staticmethod
    def _elastic(tenant: Tenant):
        """The tenant's engine when it supports level switching."""
        engine = tenant.engine
        return engine if hasattr(engine, "set_level") else None

    def _record(self, tenant: Tenant, from_level, action, to_level,
                reason, shed_delta, applied) -> QualityRecord:
        rec = QualityRecord(
            seq=self._seq,
            at_s=self._clock(),
            tenant=tenant.name,
            action=action,
            from_level=from_level,
            to_level=to_level,
            reason=reason,
            shed_delta=shed_delta,
            backlog_batches=tenant.backlog_batches(extra=0),
            est_step_s=tenant.step_expected_s(),
            deadline_s=tenant.deadline_s,
            applied=applied,
        )
        self._seq += 1
        self.journal.append(rec)
        return rec

    def _wider_fits(self, tenant: Tenant, engine) -> bool:
        """Would the next-wider level's step fit in ``headroom ×
        deadline``?  (Always, for deadline-free tenants.)"""
        if math.isinf(tenant.deadline_s):
            return True
        cfg = engine.level_config(engine.level - 1)
        est = cfg.expected_time_per_example * cfg.proper_batch_size
        return est <= self.headroom * tenant.deadline_s

    def observe(self, router: "FleetRouter") -> list:
        """One hysteresis tick over the router's elastic tenants;
        returns the records journaled this tick."""
        out = []
        for t in router.tenants():
            engine = self._elastic(t)
            if engine is None:
                continue
            name = t.name
            shed = t.rejected - self._last_rejected.get(name, 0)
            self._last_rejected[name] = t.rejected
            if shed > 0:
                self._lo[name] = 0
                self._hi[name] = self._hi.get(name, 0) + 1
                if self._hi[name] < self.degrade_after:
                    continue
                self._hi[name] = 0
                if engine.can_degrade():
                    # journal the pre-switch level: set_level mutates
                    # engine.level when it applies immediately
                    frm = engine.level
                    target = frm + 1
                    applied = engine.set_level(target)
                    out.append(self._record(
                        t, frm, "degrade", target,
                        f"{shed} sheds, sustained "
                        f"{self.degrade_after} rounds",
                        shed, applied,
                    ))
                else:
                    out.append(self._record(
                        t, engine.level, "floor_hold", engine.level,
                        f"overloaded at quality_floor "
                        f"{engine.quality_floor}; shedding",
                        shed, False,
                    ))
            else:
                self._hi[name] = 0
                self._lo[name] = self._lo.get(name, 0) + 1
                if (
                    self._lo[name] >= self.restore_after
                    and engine.can_restore()
                    and self._wider_fits(t, engine)
                ):
                    self._lo[name] = 0
                    frm = engine.level
                    target = frm - 1
                    applied = engine.set_level(target)
                    out.append(self._record(
                        t, frm, "restore", target,
                        f"shed-free {self.restore_after} rounds, "
                        "wider step fits headroom",
                        0, applied,
                    ))
        return out


class FleetRouter:
    def __init__(self, *, ledger=None, quality=None):
        self._tenants: dict[str, Tenant] = {}
        self.ledger = ledger
        self.quality = quality

    def add_tenant(
        self,
        name: str,
        engine: ServingEngine,
        *,
        priority: int = 0,
        deadline_s: float = math.inf,
        controller=None,
        live_min_samples: int = 3,
    ) -> Tenant:
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        if deadline_s <= 0.0:
            raise ValueError("deadline_s must be positive")
        if live_min_samples < 1:
            raise ValueError("live_min_samples must be >= 1")
        tenant = Tenant(
            name=name, engine=engine, priority=priority,
            deadline_s=deadline_s, controller=controller,
            live_min_samples=live_min_samples,
        )
        self._tenants[name] = tenant
        return tenant

    def tenant(self, name: str) -> Tenant:
        return self._tenants[name]

    def tenants(self) -> tuple:
        return tuple(self._tenants.values())

    # -- admission ---------------------------------------------------
    def admit(self, name: str) -> bool:
        """Would a request for `name` submitted now make its
        deadline?  Estimate: batches ahead of it times the tenant's
        expected step time (coalescing wait is bounded by the same
        step cadence, so one backlog term covers both)."""
        t = self._tenants[name]
        if math.isinf(t.deadline_s):
            return True
        est = t.backlog_batches() * t.step_expected_s()
        return est <= t.deadline_s

    def submit(self, name: str, x) -> Request | None:
        """Enqueue one example for tenant `name`, or reject it
        (returns ``None``, counted in :meth:`stats`) when its
        predicted completion violates the tenant's deadline.
        Thread-safe: the admit decision, the counter, and the enqueue
        happen under the tenant's lock, so counters never drop
        increments and two racing submits cannot both squeeze into
        the last slot the deadline allowed."""
        t = self._tenants[name]
        with t.lock:
            if not self.admit(name):
                t.rejected += 1
                return None
            t.admitted += 1
            return t.engine.submit(x)

    # -- dispatch ----------------------------------------------------
    def _dispatch_order(self, *, force: bool) -> list:
        ready = [
            t for t in self._tenants.values()
            if (t.engine.batcher.pending() > 0 if force
                else t.engine.batcher.ready())
        ]
        # strict priority; deadline breaks ties (tightest SLO first);
        # name last so dispatch order is deterministic
        return sorted(
            ready, key=lambda t: (-t.priority, t.deadline_s, t.name)
        )

    def step(self, *, force: bool = False) -> dict:
        """One dispatch round: every tenant with a ready batch (any
        pending request under ``force``) takes one engine step, in
        priority/deadline order.  Returns {tenant: requests served}
        for the tenants that served."""
        served = {}
        for t in self._dispatch_order(force=force):
            stepper = t.controller.step if t.controller else t.engine.step
            done = stepper(force=force)
            if self.ledger is not None:
                self.ledger.close_step(t.name)
            if done:
                served[t.name] = done
        if self.quality is not None:
            # after dispatch: this round's sheds are on the counters,
            # and level switches land at an idle batch boundary
            self.quality.observe(self)
        return served

    def drain(self, *, max_steps: int = 1000) -> dict:
        """Forced steps until every tenant's queue is empty (bounded
        by ``max_steps``).  Returns total {tenant: served}."""
        total: dict = {}
        for _ in range(max_steps):
            served = self.step(force=True)
            if not served:
                break
            for name, n in served.items():
                total[name] = total.get(name, 0) + n
        return total

    def stats(self) -> dict:
        """Per-tenant admission/served counters for reporting.
        Elastic tenants additionally report their current subnet
        level, floor, switch count and degraded-time share."""
        out = {}
        for t in self._tenants.values():
            row = {
                "priority": t.priority,
                "deadline_s": t.deadline_s,
                "admitted": t.admitted,
                "rejected": t.rejected,
                "served": t.engine.served,
                "steps": t.engine.steps,
                "swaps": t.engine.swaps,
                # which estimate admission is currently running on
                "admission": (
                    "live" if t.live_step_s() is not None
                    else "profiled"
                ),
            }
            if hasattr(t.engine, "set_level"):
                row.update(
                    level=t.engine.level,
                    quality_floor=t.engine.quality_floor,
                    level_switches=t.engine.level_switches,
                    degraded_share=t.engine.degraded_share,
                )
            out[t.name] = row
        return out
