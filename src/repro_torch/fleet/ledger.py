"""Device-time ledger: who actually occupied which processor.

The joint mapper's interference model needs each tenant's *share* of
host and device time; predictions (``placement_shares`` of the served
configuration) are only as good as the profile they came from.
:class:`DeviceTimeLedger` meters the real thing: every tenant's
engine feeds it one observation per (step, segment) through the
engine's always-on ``observer`` hook, and the ledger accumulates
per-tenant host/device occupancy over a bounded window of recent
steps.

Two consumers:

* :func:`repro_torch.fleet.scheduler.map_fleet` — re-plans against
  *measured* co-runner shares (``shares()`` / ``co_runner_share()``)
  instead of the demand model, so a tenant whose traffic died down
  stops inflating everyone else's placements;
* per-tenant drift detection — the ledger's per-tenant totals make
  "who is being slowed by whom" auditable (``snapshot()`` rides in
  journal records and bench output).

Metering truth has a cost: an engine observer makes the segment
pipeline wait for each device segment to read its wall time (see
``repro_torch.serving.pipeline``).  Fleet dispatch is batch-at-a-time
through the router, where that sync is already on the completion
path; latency-critical single-tenant serving should sample instead
(``SegmentTelemetry``).

Thread-safety: ``record`` and the read methods take an internal lock,
so engines stepped from different threads may share one ledger.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque

from repro_torch.core.mapper import DEVICE, HOST


@dataclasses.dataclass(frozen=True)
class TenantUsage:
    """One tenant's metered occupancy over the retained window."""

    tenant: str
    host_s: float
    device_s: float
    steps: int

    @property
    def total_s(self) -> float:
        return self.host_s + self.device_s

    def share(self, placement: str) -> float:
        """Fraction of this tenant's own busy time spent on
        `placement` — the measured analogue of
        ``EfficientConfiguration.placement_shares``."""
        if self.total_s <= 0.0:
            return 0.0
        s = self.host_s if placement == HOST else self.device_s
        return s / self.total_s


class DeviceTimeLedger:
    """Per-tenant host/device occupancy metering over a sliding
    window of engine steps."""

    def __init__(self, *, window: int = 64):
        if window <= 0:
            raise ValueError("window must be positive")
        self.window = window
        self._lock = threading.Lock()
        # tenant -> deque of (host_s, device_s) per completed step
        self._steps: dict[str, deque] = {}
        # tenant -> [host_s, device_s] accumulating the current step
        self._open: dict[str, list] = {}

    # -- engine-facing ----------------------------------------------
    def observer(self, tenant: str):
        """The always-on segment observer for `tenant`'s engine
        (``ServingEngine(observer=ledger.observer(name))``): each
        (segment, wall seconds) lands in the tenant's open step."""

        def on_segment(seg_index, segment, seconds, batch):
            del seg_index, batch
            self.record(tenant, segment.placement, seconds)

        return on_segment

    def record(self, tenant: str, placement: str, seconds: float) -> None:
        with self._lock:
            acc = self._open.setdefault(tenant, [0.0, 0.0])
            acc[0 if placement == HOST else 1] += max(0.0, seconds)

    def close_step(self, tenant: str) -> None:
        """Fold `tenant`'s open accumulation into its window — call
        once per engine step (the router does, after each dispatch).
        A step with no observations closes to nothing."""
        with self._lock:
            acc = self._open.pop(tenant, None)
            if acc is None:
                return
            steps = self._steps.setdefault(
                tenant, deque(maxlen=self.window)
            )
            steps.append((acc[0], acc[1]))

    # -- consumer-facing --------------------------------------------
    def tenants(self) -> tuple:
        with self._lock:
            return tuple(sorted(set(self._steps) | set(self._open)))

    def usage(self, tenant: str) -> TenantUsage:
        with self._lock:
            rows = list(self._steps.get(tenant, ()))
            open_acc = self._open.get(tenant)
            # snapshot the open step while still holding the lock — a
            # concurrent record() mutates the same list, and a torn
            # (host_s, device_s) pair would feed inconsistent shares
            # into the planner
            if open_acc is not None:
                rows.append(tuple(open_acc))
        return TenantUsage(
            tenant=tenant,
            host_s=sum(r[0] for r in rows),
            device_s=sum(r[1] for r in rows),
            steps=len(rows),
        )

    def step_rows(self, tenant: str) -> tuple:
        """The retained **closed** (host_s, device_s) step pairs for
        `tenant`, oldest first — the raw per-step occupancy
        :class:`repro_torch.estimator.InterferenceFit` consumes when
        calibrating the contention law.  The open step is excluded:
        a partially-accumulated pair would read as a spurious
        speedup."""
        with self._lock:
            return tuple(self._steps.get(tenant, ()))

    def shares(self) -> dict:
        """{tenant: (host_share, device_share)} over the retained
        window — each tenant's measured demand profile."""
        return {
            t: (u.share(HOST), u.share(DEVICE))
            for t in self.tenants()
            for u in (self.usage(t),)
        }

    def co_runner_share(self, tenant: str, placement: str) -> float:
        """Sum of *other* tenants' shares on `placement` — the input
        to :func:`repro_torch.core.cost_model.contention_inflation` when
        planning `tenant`'s next mapping from measured occupancy."""
        return sum(
            self.usage(t).share(placement)
            for t in self.tenants()
            if t != tenant
        )

    def reset(self, tenant: str | None = None) -> None:
        """Drop metered history — for one tenant (its mapping was
        swapped, so its occupancy profile re-keys) or the whole
        ledger."""
        with self._lock:
            if tenant is None:
                self._steps.clear()
                self._open.clear()
            else:
                self._steps.pop(tenant, None)
                self._open.pop(tenant, None)

    def snapshot(self) -> dict:
        """Plain-dict summary for journals / bench derived columns."""
        out = {}
        for t in self.tenants():
            u = self.usage(t)
            out[t] = {
                "steps": u.steps,
                "host_s": u.host_s,
                "device_s": u.device_s,
                "host_share": u.share(HOST),
                "device_share": u.share(DEVICE),
            }
        return out
