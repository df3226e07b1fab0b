"""Drift detection: observed segment latencies vs the profile the DP
priced.

The mapper chose its configuration by minimizing predicted times from
a :class:`~repro_torch.core.profiler.ProfileTable`; serving conditions
(CPU/GPU contention, thermal throttling, co-tenant load) can move the
real numbers.  :class:`DriftDetector` compares the telemetry EWMA of
each segment against the configuration's own prediction
(``EfficientConfiguration.segment_expected_times``) and flags a
segment as *drifted* only when the deviation is

* **large** — relative error beyond ``rel_threshold`` — and
* **sustained** — the deviation statistic is the **floor (minimum) of
  the last ``min_samples`` samples** (at least that many must exist),
  matching the best-of-N semantics the profiler priced the table
  under: genuine contention lifts even the best observation, so the
  floor crosses the threshold within ``min_samples`` batches of onset
  — while a transient stall, even one spanning ``min_samples - 1``
  consecutive batches, leaves the floor at the true cost.  One slow
  batch (or several) can never trigger a remap by construction — and
* **material** — the segment's share of the configuration's expected
  time is at least ``min_share``, taking the *larger* of its predicted
  and observed cost (a segment priced as negligible but observed as
  expensive is exactly the contention case), so noise on a segment
  that is negligible both ways never forces a re-solve.

``direction="slow"`` (default) reacts only to segments *slower* than
predicted — the contention case the remap can route around.
``"both"`` also reports faster-than-predicted segments, which a
controller may fold back to tighten the profile.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.mapper import EfficientConfiguration

DIRECTIONS = ("slow", "both")


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """One drifted segment: the evidence a remap decision cites."""

    segment_index: int
    placement: str
    predicted_s: float        # per-example, from the configuration
    observed_s: float         # per-example recent-floor from telemetry
    samples: int

    @property
    def ratio(self) -> float:
        """observed / predicted (> 1 means slower than priced)."""
        if self.predicted_s <= 0.0:
            return float("inf")
        return self.observed_s / self.predicted_s


class DriftDetector:
    def __init__(
        self,
        *,
        rel_threshold: float = 0.5,
        min_samples: int = 8,
        min_share: float = 0.01,
        direction: str = "slow",
    ):
        if rel_threshold <= 0.0:
            raise ValueError("rel_threshold must be positive")
        if min_samples < 1:
            raise ValueError("min_samples must be >= 1")
        if direction not in DIRECTIONS:
            raise ValueError(
                f"direction must be one of {DIRECTIONS}, got {direction!r}"
            )
        self.rel_threshold = rel_threshold
        self.min_samples = min_samples
        self.min_share = min_share
        self.direction = direction

    def check(
        self, config: EfficientConfiguration, telemetry
    ) -> tuple:
        """Drifted segments of `config` given `telemetry`, as a tuple
        of :class:`DriftReport` (empty: no sustained deviation)."""
        predicted = config.segment_expected_times()
        total = sum(predicted)
        segments = config.segments()
        reports = []
        for idx, (seg, pred) in enumerate(zip(segments, predicted)):
            stats = telemetry.observed(idx)
            # gate on samples actually *retained*, not the lifetime
            # count: with a telemetry window shorter than min_samples,
            # recent_floor would min over fewer samples than the
            # hysteresis contract promises and a short stall could
            # fake a sustained regime change
            if stats is None or len(stats.window) < self.min_samples:
                continue
            obs = stats.recent_floor(self.min_samples)
            if total > 0.0 and max(pred, obs) / total < self.min_share:
                continue
            hi = pred * (1.0 + self.rel_threshold)
            lo = pred / (1.0 + self.rel_threshold)
            slow = obs > hi
            fast = obs < lo and self.direction == "both"
            if not (slow or fast):
                continue
            reports.append(
                DriftReport(
                    segment_index=idx,
                    placement=seg.placement,
                    predicted_s=pred,
                    observed_s=obs,
                    samples=stats.count,
                )
            )
        return tuple(reports)
