"""Drift-triggered remapping: fold live telemetry back into the
profile, re-run the DP mapper, hot-swap the result.

The closed loop::

    SegmentPipeline --observer--> SegmentTelemetry
                                        |
                                  DriftDetector      (sustained dev.?)
                                        |
    ProfileTable  --fold_observed--> corrected table (drifted layers'
                                        |             rows only)
                                  DP mapper          (same registry
                                        |             candidate sets)
    ServingEngine <--swap_configuration-+            (batch boundary,
                                                      journaled)

:func:`fold_observed` is the measurement-to-model bridge: a drifted
segment's observed/predicted ratio scales the kernel times of *that
segment's layers* for every candidate config with the drifted
placement — contention is a property of the processor, not of one
kernel, so every same-placed candidate of the affected layers is
repriced and the DP can route around the contended processor (or stay,
if it is still cheapest).  Un-drifted layers' rows are untouched.

:class:`RemapController` owns the loop.  Remapping re-solves at the
batch size the engine is serving (``batch_sizes=(proper,)``), so the
batcher's padding targets stay valid across swaps; each remap appends
a :class:`SwapRecord` to :attr:`RemapController.journal` — every
mapping the engine ever served is auditable back to the telemetry that
evicted its predecessor.  When a :class:`~repro_torch.store.ProfileStore` is
attached, the new *mapping* is persisted on every swap, so the next
process on this platform warm-starts from the adapted mapping; the
corrected table is deliberately session-local (it encodes observed —
possibly transient — conditions, and an abandoned placement's rows
could never be re-observed to recover, so persisting them would let a
contention episode poison warm starts forever).
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.core.mapper import (
    EfficientConfiguration,
    map_efficient_configuration,
    price_mapping,
)
from repro_torch.core.parallel_config import is_host_config
from repro_torch.core.plan import require_binary_labels
from repro_torch.core.profiler import ProfileTable
from repro_torch.adapt.drift import DriftDetector


def fold_observed(
    table: ProfileTable,
    config: EfficientConfiguration,
    reports,
    *,
    min_factor: float = 1e-3,
) -> ProfileTable:
    """A corrected copy of `table`: for each drifted segment, scale the
    kernel times of its layers' same-placement candidate rows by the
    observed/predicted ratio (clamped below by ``min_factor``), at
    every profiled batch size; totals are rebuilt as kernel plus the
    unchanged boundary.  Rows of un-drifted layers are shared, not
    copied — only the drifted layers' rows change."""
    factors: dict[int, float] = {}          # layer index -> scale
    placements: dict[int, bool] = {}        # layer index -> host?
    segments = config.segments()
    for rep in reports:
        seg = segments[rep.segment_index]
        f = max(rep.ratio, min_factor)
        for i in range(seg.start, seg.stop):
            factors[i] = f
            placements[i] = not seg.on_device
    if not factors:
        return table

    times: dict = {}
    kernels: dict = {}
    for b in table.batch_sizes:
        times[b], kernels[b] = [], []
        for i in range(len(table.layer_labels)):
            if i not in factors:
                times[b].append(table.times[b][i])
                kernels[b].append(
                    table.kernel_times[b][i]
                    if table.kernel_times is not None
                    else table.times[b][i]
                )
                continue
            f, host_drifted = factors[i], placements[i]
            krow, trow = {}, {}
            for cfg in table.configs_for(b, i):
                k = table.kernel_time(b, i, cfg)
                if is_host_config(cfg) == host_drifted:
                    k *= f
                krow[cfg] = k
                trow[cfg] = k + table.boundary_time(b, i, cfg)
            kernels[b].append(krow)
            times[b].append(trow)
    return ProfileTable(
        model_name=table.model_name,
        batch_sizes=table.batch_sizes,
        layer_labels=table.layer_labels,
        times=times,
        kernel_times=kernels,
        h2d_times=table.h2d_times,
        d2h_times=table.d2h_times,
    )


@dataclasses.dataclass(frozen=True)
class SwapRecord:
    """One journal entry: why a mapping was evicted and what replaced
    it.  ``new_expected_s <= old_expected_s`` always holds on the
    corrected table (the old mapping is a feasible DP path)."""

    at_step: int                  # engine.steps when the swap fired
    requested_t: float
    applied_immediately: bool     # False: deferred to the batch boundary
    changed: bool                 # mapping differs (vs. reprice-only)
    reports: tuple                # the DriftReports that triggered it
    old_configs: tuple
    new_configs: tuple
    old_expected_s: float         # old mapping priced on corrected table
    new_expected_s: float
    telemetry: dict               # SegmentTelemetry.snapshot() at swap
    # which engine this record belongs to: "" for a single-tenant
    # process (legacy records), the tenant id when several engines'
    # controllers journal in one process
    tenant: str = ""

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["reports"] = [dataclasses.asdict(r) for r in self.reports]
        return d


class RemapController:
    """Owns the telemetry -> drift -> remap -> swap loop for one
    engine.  Drive it with :meth:`step` (delegates to the engine, then
    checks drift) or call :meth:`maybe_remap` from your own loop."""

    def __init__(
        self,
        engine,
        table: ProfileTable,
        *,
        telemetry=None,
        detector: DriftDetector | None = None,
        policy: str = "dp",
        configs=None,
        store=None,
        max_remaps: int | None = None,
        clock=time.monotonic,
        tenant: str | None = None,
    ):
        """``tenant`` namespaces this controller's journal records —
        required (in spirit) when several engines' controllers share a
        process, or two fleets' ``SwapRecord``s are ambiguous.  It
        defaults to the telemetry's own tenant id, so naming the
        telemetry once (``SegmentTelemetry(tenant=...)``) names the
        whole loop."""
        require_binary_labels(table.layer_labels, "adapt's remap")
        telemetry = telemetry if telemetry is not None else engine.telemetry
        if telemetry is None:
            raise ValueError(
                "RemapController needs telemetry — construct the engine "
                "with telemetry=SegmentTelemetry(...) or pass one here"
            )
        self.engine = engine
        self.table = table
        self.telemetry = telemetry
        self.detector = detector if detector is not None else DriftDetector()
        self.policy = policy
        self.configs = configs
        self.store = store
        self.max_remaps = max_remaps
        self._clock = clock
        self.tenant = (
            tenant if tenant is not None
            else getattr(telemetry, "tenant", "")
        )
        self.journal: list = []

    def step(self, *, force: bool = False) -> int:
        """One serve-then-adapt cycle: engine step, then a drift check
        at the batch boundary.  Returns requests completed."""
        done = self.engine.step(force=force)
        if done:
            self.maybe_remap()
        return done

    def maybe_remap(self) -> SwapRecord | None:
        """Check drift; on sustained deviation, correct the profile,
        re-map at the serving batch size, and hot-swap.  Returns the
        journal entry, or None when nothing drifted (or the remap
        budget is exhausted)."""
        if self.max_remaps is not None and len(self.journal) >= self.max_remaps:
            return None
        old = self.engine.config
        reports = self.detector.check(old, self.telemetry)
        if not reports:
            return None

        corrected = fold_observed(self.table, old, reports)
        batch = old.proper_batch_size
        new = map_efficient_configuration(
            corrected,
            policy=self.policy,
            configs=self.configs,
            batch_sizes=(batch,),
        )
        old_on_corrected = price_mapping(
            corrected, batch, old.layer_configs
        )
        record = SwapRecord(
            at_step=self.engine.steps,
            requested_t=self._clock(),
            applied_immediately=self.engine.swap_configuration(new),
            changed=new.layer_configs != old.layer_configs,
            reports=reports,
            old_configs=old.layer_configs,
            new_configs=new.layer_configs,
            old_expected_s=old_on_corrected.expected_time_per_example,
            new_expected_s=new.expected_time_per_example,
            telemetry=self.telemetry.snapshot(),
            tenant=self.tenant,
        )
        self.table = corrected
        # stale segment indices + a moved baseline: start sampling anew
        self.telemetry.reset()
        self.journal.append(record)
        if self.store is not None:
            # persist the remapped configuration, NOT the corrected
            # table: corrections encode this session's observed
            # conditions — possibly a transient contention episode —
            # and rows of a placement the remap abandoned can never be
            # re-observed to recover.  The factory profile on disk
            # stays authoritative, so a poisoned row cannot outlive
            # the episode that caused it: the next process warm-starts
            # the adapted mapping and re-learns corrections live.
            self.store.save_mapping(new)
        return record
