"""Online per-segment latency telemetry for the serving runtime.

:class:`SegmentTelemetry` is the observer the ``SegmentPipeline``
drivers call once per (micro-batch, segment) execution
(``observer(seg_index, segment, seconds, batch)``).  Observations are
aggregated to **one window sample per (engine step, segment)** — the
step's best per-example time — flushed when the next step begins
(:meth:`sample`) or at any read: a step that drains a large backlog
contributes exactly one sample, so the drift detector's
``min_samples`` hysteresis counts *steps*, and one stalled wave-train
— however many micro-batches it carried — can never fake a sustained
regime change.  It keeps, per segment index of the *currently served*
configuration:

* an EWMA of per-example seconds (smoothed trend for reporting and
  journals — one slow batch moves it by ``alpha``, never to the raw
  outlier);
* a bounded sliding window of raw per-example samples: quantiles and
  recent median for reporting, and the **recent floor** (min of the
  last k) the drift detector keys on — best-of-N semantics, immune to
  any run of fewer than k slow batches.

Overhead is engineered to be near zero when it matters:

* ``enabled=False`` (or ``sample_every=0``) makes :meth:`sample`
  return ``None`` and the engine passes no observer — the pipeline
  runs its exact un-instrumented code path;
* ``sample_every=k`` instruments only every k-th engine step, because
  observing a pipelined wave must sync device segments to read true
  wall times (see ``repro_torch.serving.pipeline``) — sampling keeps the
  steady-state overlap while still feeding the EWMA.

Segment indices are only meaningful against one configuration, so a
hot swap must :meth:`reset` the telemetry (the ``RemapController``
does; the stats also record the placement observed, and ``reset``
clears the sampling phase so the first post-swap steps are observed).
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque


@dataclasses.dataclass
class SegmentStats:
    """Running statistics for one segment (per-example seconds)."""

    placement: str
    alpha: float
    window: deque
    ewma: float = math.nan
    count: int = 0

    def observe(self, s_per_example: float) -> None:
        self.count += 1
        self.window.append(s_per_example)
        if math.isnan(self.ewma):
            self.ewma = s_per_example
        else:
            self.ewma += self.alpha * (s_per_example - self.ewma)

    def quantile(self, q: float) -> float:
        if not self.window:
            return math.nan
        xs = sorted(self.window)
        idx = min(len(xs) - 1, max(0, round(q * (len(xs) - 1))))
        return xs[idx]

    def recent_median(self, k: int) -> float:
        """Median of the last `k` samples (robust trend, reporting)."""
        if not self.window:
            return math.nan
        xs = sorted(list(self.window)[-k:])
        mid = len(xs) // 2
        if len(xs) % 2:
            return xs[mid]
        return 0.5 * (xs[mid - 1] + xs[mid])

    def recent_floor(self, k: int) -> float:
        """Minimum of the last `k` samples — the drift detector's
        signal, matching the profiler's best-of-N semantics: genuine
        contention lifts even the best observation, while a transient
        stall (however long its spike) leaves the floor untouched, so
        no run of k-1 slow batches can fake a regime change."""
        if not self.window:
            return math.nan
        return min(list(self.window)[-k:])


class SegmentTelemetry:
    """Sampling observer over the serving pipeline's segments."""

    def __init__(
        self,
        *,
        alpha: float = 0.25,
        window: int = 64,
        sample_every: int = 1,
        warmup: int = 1,
        enabled: bool = True,
        tenant: str = "",
    ):
        """``tenant`` names the engine this telemetry instruments.
        Two engines co-served in one process each
        carry their own telemetry; the tenant id rides in
        :meth:`snapshot` (and from there in every ``SwapRecord``), so
        journal entries are attributable when N remap loops share a
        process."""
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        if window <= 0:
            raise ValueError("window must be positive")
        if sample_every < 0:
            raise ValueError("sample_every must be >= 0 (0 disables)")
        if warmup < 0:
            raise ValueError("warmup must be >= 0")
        self.alpha = alpha
        self.window = window
        self.sample_every = sample_every
        self.warmup = warmup
        self.enabled = enabled
        self.tenant = tenant
        self._stats: dict[int, SegmentStats] = {}
        # per-step aggregation buffer: one engine step may drain many
        # micro-batches, and each contributes an observation per
        # segment — flushed as ONE window sample (the step's best) so
        # the drift hysteresis counts *steps*, and a single stalled
        # wave-train can never fill the floor window by itself
        self._pending: dict[int, tuple] = {}   # idx -> (placement, s_ex)
        self._step = 0

    # -- engine-facing ----------------------------------------------
    def sample(self):
        """The observer for this engine step, or ``None`` when this
        step is not sampled.  Called once per non-empty step.

        The first ``warmup`` steps after construction or :meth:`reset`
        are never sampled: a hot swap resets telemetry, and the next
        step pays the new pipeline's first launches (on the card, the
        kernels' first-use build) — folding those into the EWMA would
        poison the drift baseline and trigger a spurious re-remap."""
        if not self.enabled or self.sample_every == 0:
            return None
        self.flush()                 # close out the previous step
        self._step += 1
        if self._step <= self.warmup:
            return None
        if (self._step - self.warmup - 1) % self.sample_every:
            return None
        return self.on_segment

    def on_segment(self, seg_index, segment, seconds, batch) -> None:
        s_ex = seconds / max(int(batch), 1)
        prev = self._pending.get(seg_index)
        if prev is None or s_ex < prev[1]:
            self._pending[seg_index] = (segment.placement, s_ex)

    def flush(self) -> None:
        """Fold the current step's per-segment aggregates (each step's
        best observation per segment) into the windows.  Called
        automatically at the next :meth:`sample` / read; direct
        feeders (tests, offline replay) call it to delimit steps."""
        for seg_index, (placement, s_ex) in self._pending.items():
            stats = self._stats.get(seg_index)
            if stats is None:
                stats = self._stats[seg_index] = SegmentStats(
                    placement=placement,
                    alpha=self.alpha,
                    window=deque(maxlen=self.window),
                )
            stats.observe(s_ex)
        self._pending.clear()

    # -- consumer-facing --------------------------------------------
    def stats(self) -> dict:
        """{segment_index: SegmentStats}, live (not a copy)."""
        self.flush()
        return self._stats

    def observed(self, seg_index: int) -> SegmentStats | None:
        self.flush()
        return self._stats.get(seg_index)

    def live_s_per_example(
        self, n_segments: int, *, min_count: int = 1
    ) -> float | None:
        """Live per-example seconds for one full step: the summed
        per-segment EWMAs over the served configuration's
        ``n_segments`` segments — what ``FleetRouter`` admission
        prefers over the profiled estimate once telemetry is warm.
        Returns ``None`` while cold: any segment unobserved, below
        ``min_count`` samples, or ``n_segments <= 0`` (a partial sum
        would systematically under-estimate the step and over-admit)."""
        self.flush()
        if n_segments <= 0:
            return None
        total = 0.0
        for i in range(n_segments):
            stats = self._stats.get(i)
            if (
                stats is None
                or stats.count < min_count
                or math.isnan(stats.ewma)
            ):
                return None
            total += stats.ewma
        return total

    def reset(self) -> None:
        """Drop all samples and the sampling phase — required after a
        configuration swap (segment indices re-key) and after a profile
        correction (the comparison baseline moved)."""
        self._stats.clear()
        self._pending.clear()
        self._step = 0

    def snapshot(self) -> dict:
        """Plain-dict summary for logs / the swap journal.  Segment
        entries are keyed by index; a non-empty :attr:`tenant` adds a
        ``"tenant"`` entry so multi-engine journals stay
        attributable."""
        self.flush()
        out: dict = {
            i: {
                "placement": s.placement,
                "count": s.count,
                "ewma_s": s.ewma,
                "p50_s": s.quantile(0.5),
                "p95_s": s.quantile(0.95),
            }
            for i, s in sorted(self._stats.items())
        }
        if self.tenant:
            out["tenant"] = self.tenant
        return out
