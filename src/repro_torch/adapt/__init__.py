"""Adaptive runtime: online segment telemetry + drift-triggered
remapping for the serving engine.

The offline pipeline (profile -> map -> serve) assumes serving
conditions match profiling conditions; contention at serve time breaks
that.  This package closes the loop:

* :mod:`telemetry` — :class:`SegmentTelemetry`: sampling observer over
  ``SegmentPipeline`` recording per-segment EWMA + window quantiles,
  zero overhead when disabled;
* :mod:`drift` — :class:`DriftDetector`: sustained relative deviation
  of observed vs predicted segment times (threshold + min-sample
  hysteresis);
* :mod:`controller` — :class:`RemapController` / :func:`fold_observed`
  / :class:`SwapRecord`: fold observations into a corrected
  ProfileTable (drifted layers only), re-run the DP mapper, hot-swap
  at a batch boundary with a full audit journal; persistence via
  :class:`repro_torch.store.ProfileStore`.

The port of the JAX package's ``repro.adapt``: the same classes and
functions, the same journal, over the port's mapper and engine.
"""

from repro_torch.adapt.controller import RemapController, SwapRecord, fold_observed
from repro_torch.adapt.drift import DriftDetector, DriftReport
from repro_torch.adapt.telemetry import SegmentStats, SegmentTelemetry

__all__ = [
    "DriftDetector",
    "DriftReport",
    "RemapController",
    "SegmentStats",
    "SegmentTelemetry",
    "SwapRecord",
    "fold_observed",
]
