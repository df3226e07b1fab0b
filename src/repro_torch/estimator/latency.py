"""Learned per-layer latency prediction (nnabla-nas-style estimator).

:class:`LatencyPredictor` fits one log-space linear regression per
:func:`~repro_torch.estimator.features.group_key` — (geometry class,
placement, analytic kind) — over training rows accumulated across
``ProfileStore`` entries, plus per-direction boundary-cost fits and a
coarse fallback chain, and can then synthesize a complete
:class:`~repro_torch.core.profiler.ProfileTable` for a model it has never
seen (:meth:`predict_table`).

The prediction contract is deliberately weaker than profiling — and
that is the point:

* every predicted time is finite and positive (clamped to
  ``[1e-12, 1e6]`` seconds), so a predicted table can **never** crash
  the DP mapper: it always yields a valid mapping, just a possibly
  suboptimal one;
* an unmatched row degrades through the fallback chain (exact group →
  per-class pool → global median) instead of failing — a predictor
  trained on GEMM rows still prices an elementwise layer, badly but
  usably;
* prediction seeds the DP for zero-profiling cold starts, the adaptive
  runtime's telemetry (``repro_torch.adapt``) corrects it online, and
  every real profile run feeds rows back into the store
  (``ProfileStore.get_or_profile``) so the next cold start predicts
  better.

Predicted tables are marked ``provenance="predicted"`` so consumers
(warm-start logging, bench derived columns) can tell them from
measured/analytic ones.

Fitting is ridge-regularized least squares in log space: the fixed-8
rows make several features collinear (all aspect configs share one
tile size), and the ridge term keeps the minimum-norm solution stable
instead of exploding a coefficient pair the data cannot separate.
"""

from __future__ import annotations

import json
import math

import numpy as np

from repro_torch.core.parallel_config import CONFIGS
from repro_torch.estimator.features import (
    boundary_features,
    feature_vector,
    group_key,
    layer_geometry,
    variant_meta,
)

_MIN_S = 1e-12
_MAX_S = 1e6


def _fit_loglinear(X, y, ridge: float):
    """Ridge-augmented least squares: minimizes ``|Xw - y|^2 +
    ridge * |w|^2`` via lstsq on the stacked system — stable under the
    collinear columns fixed-8 training data produces."""
    X = np.asarray(X, dtype=float)
    y = np.asarray(y, dtype=float)
    d = X.shape[1]
    Xa = np.vstack([X, math.sqrt(ridge) * np.eye(d)])
    ya = np.concatenate([y, np.zeros(d)])
    w, *_ = np.linalg.lstsq(Xa, ya, rcond=None)
    return w


class LatencyPredictor:
    """Per-group log-linear latency regression over training rows."""

    SCHEMA_VERSION = 1

    def __init__(self, *, ridge: float = 1e-6, min_rows: int = 3):
        if ridge <= 0.0:
            raise ValueError("ridge must be positive")
        if min_rows < 1:
            raise ValueError("min_rows must be >= 1")
        self.ridge = ridge
        self.min_rows = min_rows
        self._groups: dict = {}       # group_key -> weight vector
        self._pools: dict = {}        # geometry cls -> weight vector
        self._boundary: dict = {}     # "h2d"/"d2h" -> weight vector
        self._counts: dict = {}       # group_key -> training rows used
        self._default_log_s = math.log(1e-4)
        self.n_rows = 0

    # -- training ----------------------------------------------------
    def fit(self, rows) -> "LatencyPredictor":
        """Fit from training-row dicts (``features.training_rows_*``).
        Returns ``self``.  Rows with non-positive kernel times are
        dropped; boundary fits dedupe the per-layer h2d/d2h values
        (stored once per layer, repeated across that layer's
        configs)."""
        by_group: dict = {}
        by_cls: dict = {}
        boundary: dict = {"h2d": {}, "d2h": {}}
        all_logs: list = []
        n = 0
        for r in rows:
            geom, meta = r["geometry"], r["meta"]
            t = float(r.get("kernel_s", 0.0))
            if not (t > 0.0) or not math.isfinite(t):
                continue
            n += 1
            x = feature_vector(geom, meta)
            logt = math.log(max(t, _MIN_S))
            key = group_key(geom, meta)
            by_group.setdefault(key, ([], []))
            by_group[key][0].append(x)
            by_group[key][1].append(logt)
            by_cls.setdefault(geom["cls"], ([], []))
            by_cls[geom["cls"]][0].append(x)
            by_cls[geom["cls"]][1].append(logt)
            all_logs.append(logt)
            # one boundary sample per (model, layer, batch, direction)
            bkey = (r.get("model", ""), r.get("layer", -1), geom["b"])
            for direction in ("h2d", "d2h"):
                v = float(r.get(f"{direction}_s", 0.0))
                if v > 0.0 and math.isfinite(v):
                    boundary[direction].setdefault(
                        bkey, (boundary_features(geom, direction),
                               math.log(max(v, _MIN_S)))
                    )
        self._groups.clear()
        self._pools.clear()
        self._boundary.clear()
        self._counts.clear()
        for key, (X, y) in by_group.items():
            self._counts[key] = len(y)
            if len(y) >= self.min_rows:
                self._groups[key] = _fit_loglinear(X, y, self.ridge)
        for cls, (X, y) in by_cls.items():
            if len(y) >= self.min_rows:
                self._pools[cls] = _fit_loglinear(X, y, self.ridge)
        for direction, samples in boundary.items():
            if len(samples) >= self.min_rows:
                X = [x for x, _ in samples.values()]
                y = [v for _, v in samples.values()]
                self._boundary[direction] = _fit_loglinear(
                    X, y, self.ridge
                )
        if all_logs:
            self._default_log_s = float(np.median(all_logs))
        self.n_rows = n
        return self

    # -- prediction --------------------------------------------------
    @staticmethod
    def _clamp(log_s: float) -> float:
        if not math.isfinite(log_s):
            return 1e-4
        return min(max(math.exp(log_s), _MIN_S), _MAX_S)

    def predict_kernel_s(self, geometry: dict, meta: dict) -> float:
        """Kernel-only seconds per example for one (layer geometry,
        variant meta) pair — exact group fit, else the geometry
        class's pooled fit, else the global median.  Always finite
        and positive."""
        x = np.asarray(feature_vector(geometry, meta), dtype=float)
        for w in (
            self._groups.get(group_key(geometry, meta)),
            self._pools.get(geometry["cls"]),
        ):
            if w is not None and len(w) == len(x):
                return self._clamp(float(x @ w))
        return self._clamp(self._default_log_s)

    def predict_boundary_s(self, geometry: dict, direction: str) -> float:
        """Per-example seconds for the layer's ``"h2d"``/``"d2h"``
        transfer (0.0 when that direction was never trained)."""
        w = self._boundary.get(direction)
        if w is None:
            return 0.0
        x = np.asarray(boundary_features(geometry, direction), dtype=float)
        return self._clamp(float(x @ w))

    def predict_table(
        self,
        model,
        batch_sizes,
        *,
        registry=None,
        configs=None,
        platform=None,
    ):
        """Synthesize a full ``ProfileTable`` for `model` with zero
        profiling passes.

        Candidates per layer are `configs` (default: the fixed-8
        space) plus, when a `registry` is given, every layer-scope
        variant whose applicability predicate accepts the layer's
        GEMM shape on `platform` (``None`` -> ``"cuda"``: the predictor
        prices the card, as the analytic sweep does) — the same space
        ``autotune_bnn_model`` would sweep.  Rows follow profiler
        semantics exactly (per-example seconds; device totals carry
        the full h2d+d2h roundtrip), so the table drops into the DP
        mapper, the store and the serving stack unchanged.
        """
        from repro_torch.core.profiler import ProfileTable

        base = tuple(configs) if configs is not None else CONFIGS
        platform = "cuda" if platform is None else platform
        batch_sizes = tuple(int(b) for b in batch_sizes)
        labels = tuple(f"L{s.idx}:{s.notation}" for s in model.specs)
        times: dict = {}
        kernels: dict = {}
        h2d: dict = {}
        d2h: dict = {}
        for b in batch_sizes:
            per, perk, ph, pd = [], [], [], []
            for spec in model.specs:
                geom = layer_geometry(spec, b)
                cand = list(base)
                if registry is not None and geom["cls"] == "gemm":
                    from repro_torch.kernels.registry import GemmShape

                    shape = GemmShape(
                        b=b, p=geom["p"], n=geom["n"], kw=geom["kw"]
                    )
                    cand += [
                        v.name
                        for v in registry.applicable(shape, platform)
                        if v.name not in cand
                    ]
                lh2d = self.predict_boundary_s(geom, "h2d")
                ld2h = self.predict_boundary_s(geom, "d2h")
                row, krow = {}, {}
                for cfg in cand:
                    meta = variant_meta(cfg, registry)
                    k = self.predict_kernel_s(geom, meta)
                    krow[cfg] = k
                    row[cfg] = (
                        k if meta["placement"] == "host"
                        else k + lh2d + ld2h
                    )
                per.append(row)
                perk.append(krow)
                ph.append(lh2d)
                pd.append(ld2h)
            times[b] = per
            kernels[b] = perk
            h2d[b] = ph
            d2h[b] = pd
        return ProfileTable(
            model_name=model.name,
            batch_sizes=batch_sizes,
            layer_labels=labels,
            times=times,
            kernel_times=kernels,
            h2d_times=h2d,
            d2h_times=d2h,
            provenance="predicted",
        )

    # -- introspection / persistence --------------------------------
    def coverage(self) -> dict:
        """{group_key: training rows seen} — which regions of the
        config space the predictor has actually learned (groups below
        ``min_rows`` counted but unfitted)."""
        return dict(self._counts)

    def to_json(self) -> str:
        def ser(d):
            return {k: [float(v) for v in w] for k, w in d.items()}

        return json.dumps(
            {
                "schema": self.SCHEMA_VERSION,
                "kind": "latency_predictor",
                "ridge": self.ridge,
                "min_rows": self.min_rows,
                "n_rows": self.n_rows,
                "groups": ser(self._groups),
                "pools": ser(self._pools),
                "boundary": ser(self._boundary),
                "counts": dict(self._counts),
                "default_log_s": self._default_log_s,
            },
            indent=2,
        )

    @staticmethod
    def from_json(s: str) -> "LatencyPredictor":
        d = json.loads(s)
        if d.get("schema", 1) > LatencyPredictor.SCHEMA_VERSION:
            raise ValueError(
                "latency_predictor schema is newer than supported"
            )
        if d.get("kind", "latency_predictor") != "latency_predictor":
            raise ValueError(
                f"expected a latency_predictor document, got "
                f"{d.get('kind')!r}"
            )
        p = LatencyPredictor(
            ridge=d.get("ridge", 1e-6), min_rows=d.get("min_rows", 3)
        )
        for attr, key in (
            ("_groups", "groups"),
            ("_pools", "pools"),
            ("_boundary", "boundary"),
        ):
            getattr(p, attr).update(
                {k: np.asarray(w, dtype=float)
                 for k, w in d.get(key, {}).items()}
            )
        p._counts.update(d.get("counts", {}))
        p._default_log_s = float(d.get("default_log_s", math.log(1e-4)))
        p.n_rows = int(d.get("n_rows", 0))
        return p
