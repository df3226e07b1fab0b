"""Elastic host-pool control: grow on sustained high occupancy,
drain-then-retire on sustained low, journal every decision.

Re-exported here: :func:`~repro_torch.runtime.elastic.remesh_state`,
the state-migration hook for tenants whose parameters are sharded
across a host's devices (it places a params tree as DTensors on a new
``DeviceMesh``).  No BNN path calls it.  The control loop over the
serving cluster:

* the controller watches each host's **windowed occupancy** (busy
  fraction of its recent dispatch rounds — the host-level roll-up of
  what the device-time ledger meters per tenant);
* mean occupancy >= ``high_water`` for ``sustain`` consecutive
  observations → **degrade width** when the cluster hosts elastic
  tenants with floor room (``repro_torch.elastic`` — a narrower subnet is a
  batch-boundary swap, far cheaper than a host), else **scale up**
  (add a host, replicate the hottest host's tenants onto it);
  symmetrically, low water restores degraded width before it drains
  a host;
* mean occupancy <= ``low_water`` for ``sustain`` observations →
  **drain** the emptiest host: it stops accepting requests, finishes
  its in-flight batches bit-exact, and only then **retires**;
* while any host is draining, a newly-triggered decision is
  **deferred** — journaled but not acted on — mirroring the serving
  engine's deferred-swap semantics (never two topology changes in
  flight at once).

Every decision (including deferrals) appends a :class:`ScaleRecord`
to the controller's journal, the cluster-level analogue of the adapt
loop's ``SwapRecord``: scaling that can't explain itself can't be
trusted in a latency postmortem.
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.cluster.host import ACTIVE, DRAINING
from repro_torch.runtime.elastic import remesh_state

__all__ = ["ElasticController", "ScaleRecord", "remesh_state"]


@dataclasses.dataclass(frozen=True)
class ScaleRecord:
    """One journaled scaling decision."""

    seq: int                     # decision number, monotonically increasing
    at_s: float                  # controller clock at decision time
    action: str                  # scale_up | drain | retire | deferred
    reason: str                  # human-readable trigger
    occupancy: dict              # host_id -> windowed busy fraction
    n_active_before: int
    n_active_after: int
    moved_tenants: tuple = ()    # tenants (re)placed by this action

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["moved_tenants"] = list(self.moved_tenants)
        return d


class ElasticController:
    """Watches a :class:`~repro_torch.cluster.Cluster`'s host pool and
    makes grow/shrink decisions.  Drive it by calling
    :meth:`observe` once per serving tick (the cluster's ``step``
    does this when the controller is attached)."""

    def __init__(
        self,
        *,
        high_water: float = 0.75,
        low_water: float = 0.15,
        sustain: int = 3,
        min_hosts: int = 1,
        max_hosts: int = 8,
        clock=time.monotonic,
    ):
        if not 0.0 <= low_water < high_water <= 1.0:
            raise ValueError(
                "need 0 <= low_water < high_water <= 1, got "
                f"low={low_water} high={high_water}"
            )
        if sustain < 1:
            raise ValueError("sustain must be >= 1")
        if not 1 <= min_hosts <= max_hosts:
            raise ValueError("need 1 <= min_hosts <= max_hosts")
        self.high_water = high_water
        self.low_water = low_water
        self.sustain = sustain
        self.min_hosts = min_hosts
        self.max_hosts = max_hosts
        self._clock = clock
        self._hi_streak = 0
        self._lo_streak = 0
        self.journal: list = []

    # -- journaling --------------------------------------------------
    def _record(
        self, action, reason, occ, before, after, moved=()
    ) -> ScaleRecord:
        rec = ScaleRecord(
            seq=len(self.journal), at_s=self._clock(), action=action,
            reason=reason, occupancy=dict(occ),
            n_active_before=before, n_active_after=after,
            moved_tenants=tuple(moved),
        )
        self.journal.append(rec)
        return rec

    # -- control loop ------------------------------------------------
    def observe(self, cluster) -> ScaleRecord | None:
        """One control tick.  Retires finished drains first (that
        completes the previous decision), then evaluates the water
        marks.  Returns the journal entry when anything happened —
        including a deferral — else ``None``."""
        active = [h for h in cluster.hosts if h.status == ACTIVE]
        draining = [h for h in cluster.hosts if h.status == DRAINING]
        occ = {h.host_id: h.occupancy() for h in active}

        # 1) complete an in-flight drain: retire once empty
        for h in draining:
            if h.pending() == 0:
                h.retire()
                cluster.on_retired(h)
                return self._record(
                    "retire",
                    f"host {h.host_id} drained empty",
                    occ, len(active), len(active),
                )

        mean_occ = (
            sum(occ.values()) / len(occ) if occ else 0.0
        )
        self._hi_streak = (
            self._hi_streak + 1 if mean_occ >= self.high_water else 0
        )
        self._lo_streak = (
            self._lo_streak + 1 if mean_occ <= self.low_water else 0
        )

        want_up = (
            self._hi_streak >= self.sustain
            and len(active) < self.max_hosts
        )
        want_down = (
            self._lo_streak >= self.sustain
            and len(active) > self.min_hosts
        )
        if not (want_up or want_down):
            return None

        # 2) one topology change in flight at a time: a triggered
        # decision during a drain is journaled, not acted on (the
        # streak keeps building, so it fires on the next clear tick)
        if draining:
            return self._record(
                "deferred",
                f"{'scale_up' if want_up else 'drain'} triggered at "
                f"mean occupancy {mean_occ:.2f} while host "
                f"{draining[0].host_id} is draining",
                occ, len(active), len(active),
            )

        if want_up:
            self._hi_streak = 0
            # degrading an elastic tenant's width is cheaper than a
            # host: prefer it whenever a quality floor leaves room
            # (repro_torch.elastic; a narrower subnet swap is a batch
            # boundary, a new host is a topology change)
            degraded = getattr(cluster, "degrade_width", lambda: ())()
            if degraded:
                return self._record(
                    "degrade_width",
                    f"mean occupancy {mean_occ:.2f} >= "
                    f"{self.high_water} for {self.sustain} ticks; "
                    "narrowed elastic tenants instead of adding a host",
                    occ, len(active), len(active), degraded,
                )
            host, moved = cluster.scale_up()
            return self._record(
                "scale_up",
                f"mean occupancy {mean_occ:.2f} >= "
                f"{self.high_water} for {self.sustain} ticks",
                occ, len(active), len(active) + 1, moved,
            )

        self._lo_streak = 0
        # headroom pays back quality debt before it removes capacity:
        # restore degraded widths first, shrink the pool only once
        # every elastic tenant is back at full width
        restored = getattr(cluster, "restore_width", lambda: ())()
        if restored:
            return self._record(
                "restore_width",
                f"mean occupancy {mean_occ:.2f} <= {self.low_water} "
                f"for {self.sustain} ticks; restored elastic tenant "
                "width before shrinking the pool",
                occ, len(active), len(active), restored,
            )
        victim = min(active, key=lambda h: (h.occupancy(), -h.host_id))
        moved = cluster.start_drain(victim)
        return self._record(
            "drain",
            f"mean occupancy {mean_occ:.2f} <= {self.low_water} "
            f"for {self.sustain} ticks; draining host "
            f"{victim.host_id}",
            occ, len(active), len(active) - 1, moved,
        )
