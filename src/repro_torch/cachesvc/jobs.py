"""The cache service's background job kinds — each an
idempotent function returning a JSON-able result dict for the
:class:`~repro_torch.cachesvc.workqueue.JobRecord` journal.

``prewarm``
    Profile + map a (model, hardware, registry) key *ahead of demand*
    so the first real request warm-starts: :func:`prewarm_once` runs
    the store's own ``get_or_profile`` / ``load_mapping`` path, so a
    prewarmed key is byte-identical to one a cold serve would have
    written.

``refit``
    Retrain the learned estimators when enough new training rows
    accumulated since the last persisted fit: :func:`refit_once`
    compares the store's row count against the saved predictor's
    ``source_rows`` stamp and re-fits the
    :class:`~repro_torch.estimator.LatencyPredictor` (and, when ledger
    observations are supplied, the
    :class:`~repro_torch.estimator.interference.FittedInterference` law).

``explore``
    Close the exploration gap — *telemetry can only correct placements
    that execute*.  :func:`coverage_report` diffs the profile table's
    candidate placements against per-layer execution counts
    (:func:`execution_counts` over served mappings); for each
    never-or-stale-executed placement, :func:`explore_once`
    re-measures its cheapest candidate off the hot path, folds the
    observed/stored ratio back through the *existing*
    :func:`~repro_torch.adapt.controller.fold_observed` bridge (a one-layer
    shim segment per stale row), re-runs the mapper on the corrected
    table, and persists the new mapping only when it is strictly
    better than the old one repriced under the same correction.  The
    corrected table itself is never persisted — same rule as the
    adaptive runtime (transient conditions must not poison warm
    starts).  ``sweep="frontier"`` re-measures *all* stale candidates
    per row with per-candidate folding instead of the cheapest only.
    Nothing here runs on the serving path.

``flush``
    Push a write-back :class:`~repro_torch.cachesvc.TieredBackend`'s dirty
    keys to its shared back tier (:func:`flush_once`) — enqueued as a
    periodic job on the backend's ``flush_interval_s`` cadence, so
    staleness of the shared tier is bounded by the timer, not by the
    next explicit flush.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

from repro_torch.core.mapper import (
    DEVICE,
    HOST,
    Segment,
    map_efficient_configuration,
    placement_of,
    price_mapping,
)

_PLACEMENTS = (HOST, DEVICE)


def execution_counts(config, steps: int, into: dict | None = None) -> dict:
    """{(layer_index, config_name): executions} for a mapping served
    for `steps` engine steps — every layer's chosen config runs once
    per step.  Pass ``into`` to accumulate across mappings/engines
    (e.g. before and after a hot swap)."""
    counts = {} if into is None else into
    for layer, cfg in enumerate(config.layer_configs):
        ident = (layer, cfg)
        counts[ident] = counts.get(ident, 0) + int(steps)
    return counts


@dataclasses.dataclass(frozen=True)
class CoverageRow:
    """One under-explored (layer, placement): the profile table offers
    ``candidates`` there, but execution counts show fewer than
    ``min_count`` real executions — its stored rows are unverified by
    telemetry and may be arbitrarily stale."""

    layer: int
    placement: str              # mapper.HOST / mapper.DEVICE
    executed: int               # real executions on this placement
    candidates: tuple           # profiled configs never verified


def coverage_report(
    table,
    batch: int,
    counts: Mapping,
    *,
    min_count: int = 1,
) -> tuple:
    """The exploration frontier: every (layer, placement) the profile
    table prices but telemetry has executed fewer than `min_count`
    times.  ``counts`` is :func:`execution_counts` output (or a merge
    of several)."""
    if batch not in table.batch_sizes:
        raise ValueError(
            f"batch {batch} not profiled (have {table.batch_sizes})"
        )
    rows = []
    for layer in range(len(table.layer_labels)):
        row_configs = table.configs_for(batch, layer)
        for placement in _PLACEMENTS:
            cands = tuple(
                c for c in row_configs if placement_of(c) == placement
            )
            if not cands:
                continue
            executed = sum(
                n for (li, cfg), n in counts.items()
                if li == layer and placement_of(cfg) == placement
            )
            if executed < min_count:
                rows.append(
                    CoverageRow(layer, placement, executed, cands)
                )
    return tuple(rows)


class _ShimConfig:
    """Just enough of an EfficientConfiguration for
    ``fold_observed``: one single-layer segment per explored row, so
    each measured ratio scales exactly that layer's same-placement
    candidates."""

    def __init__(self, rows: Sequence[CoverageRow]):
        self._segments = tuple(
            Segment(
                start=r.layer, stop=r.layer + 1,
                placement=r.placement, configs=(),
            )
            for r in rows
        )

    def segments(self) -> tuple:
        return self._segments


@dataclasses.dataclass(frozen=True)
class _ShimReport:
    segment_index: int
    ratio: float


def _fold_candidates(table, ratios: Mapping, *, min_factor: float):
    """A corrected copy of `table` with **per-candidate** kernel-time
    scaling: ``ratios`` maps ``(layer, config) -> observed/stored``,
    and only those exact rows change (at every profiled batch);
    totals are rebuilt as kernel plus the unchanged boundary.  The
    frontier sweep needs this instead of
    :func:`~repro_torch.adapt.controller.fold_observed`, whose one ratio
    per drifted layer scales *all* same-placement candidates alike —
    correct for a segment-level drift report, wrong for a sweep that
    measured each candidate individually."""
    from repro_torch.core.profiler import ProfileTable

    touched = {layer for layer, _ in ratios}
    times: dict = {}
    kernels: dict = {}
    for b in table.batch_sizes:
        times[b], kernels[b] = [], []
        for i in range(len(table.layer_labels)):
            if i not in touched:
                times[b].append(table.times[b][i])
                kernels[b].append(
                    table.kernel_times[b][i]
                    if table.kernel_times is not None
                    else table.times[b][i]
                )
                continue
            krow, trow = {}, {}
            for cfg in table.configs_for(b, i):
                k = table.kernel_time(b, i, cfg)
                f = ratios.get((i, cfg))
                if f is not None:
                    k *= max(f, min_factor)
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


def explore_once(
    store,
    model,
    table,
    *,
    batch: int,
    counts: Mapping,
    measure_fn: Callable,
    policy: str = "dp",
    min_count: int = 1,
    min_factor: float = 1e-3,
    sweep: str = "cheapest",
) -> dict:
    """One exploration pass (the ``explore`` job body).

    ``sweep="cheapest"`` (default) measures each
    :func:`coverage_report` row's cheapest stored candidate —
    ``measure_fn(layer, config, batch) -> seconds`` — and folds the
    measured/stored kernel-time ratio back via ``fold_observed``
    (scaling the row's same-placement candidates together).
    ``sweep="frontier"`` re-measures **every** stale candidate of
    every row and folds each one's own ratio (per-candidate, via
    :func:`_fold_candidates`) — more measurement off the hot path,
    but a mis-priced non-cheapest candidate can only be caught this
    way.  Either way the old mapping is repriced on the corrected
    table (same correction, fair comparison) against a fresh mapper
    run; a strictly better, different mapping is persisted to the
    store.  Returns the journaled result dict — one ``rows`` entry
    per measurement."""
    from repro_torch.adapt.controller import fold_observed

    if sweep not in ("cheapest", "frontier"):
        raise ValueError(
            f"sweep must be 'cheapest' or 'frontier', got {sweep!r}"
        )
    rows = coverage_report(table, batch, counts, min_count=min_count)
    if not rows:
        return {"explored": 0, "improved": False, "sweep": sweep}

    measured_rows = []

    def measure(row, cfg):
        stored = table.kernel_time(batch, row.layer, cfg)
        observed = float(measure_fn(row.layer, cfg, batch))
        ratio = observed / stored if stored > 0 else 1.0
        measured_rows.append(
            {
                "layer": row.layer,
                "placement": row.placement,
                "config": cfg,
                "stored_s": stored,
                "observed_s": observed,
                "ratio": ratio,
            }
        )
        return ratio

    if sweep == "frontier":
        ratios = {
            (row.layer, cfg): measure(row, cfg)
            for row in rows
            for cfg in row.candidates
        }
        corrected = _fold_candidates(
            table, ratios, min_factor=min_factor
        )
    else:
        reports = []
        for i, row in enumerate(rows):
            ref = min(
                row.candidates,
                key=lambda c: table.kernel_time(batch, row.layer, c),
            )
            reports.append(
                _ShimReport(segment_index=i, ratio=measure(row, ref))
            )
        corrected = fold_observed(
            table, _ShimConfig(rows), reports, min_factor=min_factor
        )

    old = store.load_mapping(model, policy=policy, batch=batch)
    if old is None or old.layer_labels != table.layer_labels:
        old = map_efficient_configuration(
            table, policy=policy, batch_sizes=(batch,)
        )
    old_repriced = price_mapping(corrected, batch, old.layer_configs)
    new = map_efficient_configuration(
        corrected, policy=policy, batch_sizes=(batch,)
    )
    improved = (
        new.layer_configs != old.layer_configs
        and new.expected_time_per_example
        < old_repriced.expected_time_per_example
    )
    if improved:
        # only the mapping persists — the corrected table is
        # session-local, same rule as the adaptive runtime
        store.save_mapping(new)
    return {
        "explored": len(rows),
        "measured": len(measured_rows),
        "sweep": sweep,
        "improved": improved,
        "old_expected_s": old_repriced.expected_time_per_example,
        "new_expected_s": new.expected_time_per_example,
        "rows": measured_rows,
    }


def flush_once(backend) -> dict:
    """One write-back flush pass (the ``flush`` job body): push the
    tiered backend's dirty keys to its back tier.  Idempotent — a
    clean tier flushes zero keys."""
    pushed = int(backend.flush())
    return {"pushed": pushed, "pending": len(backend.dirty())}


def prewarm_once(
    store,
    model,
    packed_params,
    *,
    profile_fn: Callable,
    batch_sizes: Sequence[int],
    policy: str = "dp",
    configs: Sequence[str] | None = None,
) -> dict:
    """One prewarm pass (the ``prewarm`` job body): make sure the
    store holds a profile *and* a mapping for this key, running the
    same paths a cold serve would.  Idempotent — a fully warmed key
    does zero profiling and zero mapping."""
    table, loaded = store.get_or_profile(
        model, packed_params, profile_fn, batch_sizes=batch_sizes
    )
    config = store.load_mapping(model, policy=policy)
    mapped = False
    if (
        config is None
        or config.layer_labels != table.layer_labels
        or config.proper_batch_size not in table.batch_sizes
    ):
        config = map_efficient_configuration(
            table, configs=configs, policy=policy
        )
        store.save_mapping(config)
        mapped = True
    return {
        "profiled": not loaded,
        "mapped": mapped,
        "batch": config.proper_batch_size,
        "expected_s": config.expected_time_per_example,
    }


def refit_once(
    store,
    *,
    min_new_rows: int = 8,
    observations=None,
    predictor_kwargs: dict | None = None,
) -> dict:
    """One refit pass (the ``refit`` job body): retrain the
    :class:`~repro_torch.estimator.LatencyPredictor` when at least
    `min_new_rows` training rows accumulated since the last persisted
    fit (first fit counts from zero).  ``observations=(ledger,
    expected_step_s)`` additionally recalibrates the interference law
    from that ledger's slowdowns.  Idempotent — re-running after a fit
    with no new rows is a no-op."""
    from repro_torch.estimator.latency import LatencyPredictor

    rows = store.load_training_rows()
    meta = store.predictor_meta()
    fitted_on = 0 if meta is None else meta["source_rows"]
    new_rows = len(rows) - fitted_on
    out = {
        "rows": len(rows),
        "new_rows": new_rows,
        "refit": False,
        "interference": False,
    }
    if rows and new_rows >= min_new_rows:
        pred = LatencyPredictor(**(predictor_kwargs or {})).fit(rows)
        store.save_predictor(pred, source_rows=len(rows))
        out["refit"] = True
        out["n_rows"] = pred.n_rows
    if observations is not None:
        from repro_torch.estimator.interference import InterferenceFit

        ledger, expected = observations
        fit = InterferenceFit.from_ledger(ledger, expected)
        if len(fit):
            law = fit.fit()
            store.save_interference(law)
            out["interference"] = True
            out["gamma"] = law.gamma
    return out
