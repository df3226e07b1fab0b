"""Learned latency estimation and calibrated interference modeling.

Two fitted models replacing trust-the-profile with fit-from-data
(docs/ARCHITECTURE.md §12):

* :class:`LatencyPredictor` — per-variant-kind log-linear regression
  over training rows the :class:`~repro_torch.store.ProfileStore`
  accumulates from every real profile run; ``predict_table`` gives an
  unseen (model, hardware) key a usable ``ProfileTable`` with zero
  profiling passes.
* :class:`InterferenceFit` / :class:`FittedInterference` — the
  contention law ``cost_model.contention_inflation`` prices with,
  calibrated from the cross-tenant slowdowns a device-time ledger
  meters instead of an assumed ``gamma``.
"""

from repro_torch.estimator.features import (
    TRAINING_ROW_SCHEMA,
    boundary_features,
    feature_vector,
    group_key,
    layer_geometry,
    training_rows_from_table,
    variant_meta,
)
from repro_torch.estimator.interference import (
    FittedInterference,
    InterferenceFit,
    InterferenceObservation,
    fit_gamma,
)
from repro_torch.estimator.latency import LatencyPredictor

__all__ = [
    "TRAINING_ROW_SCHEMA",
    "boundary_features",
    "feature_vector",
    "group_key",
    "layer_geometry",
    "training_rows_from_table",
    "variant_meta",
    "FittedInterference",
    "InterferenceFit",
    "InterferenceObservation",
    "fit_gamma",
    "LatencyPredictor",
]
