"""Feature extraction for the learned latency estimator.

A training row pairs one profiled measurement — a (layer, batch,
config) kernel time plus the layer's boundary costs — with the two
dictionaries prediction needs:

* ``geometry`` — the layer's dispatch shape at the profiled batch
  (:func:`layer_geometry`): the GEMM dims for conv/fc layers, an
  element count for the memory-bound elementwise layers.  Everything
  here derives from the :class:`~repro_torch.bnn.layers.LayerSpec` alone,
  so an *unprofiled* model produces the same geometry and a trained
  predictor can price it sight unseen.
* ``meta`` — the config's registry metadata (:func:`variant_meta`):
  placement, analytic kind, tile sizes, aspect flags.  This is what
  lets one regression generalize across variants of the same kind
  instead of memorizing config names.  The fixed 8 carry kernel 1's
  own tiles (64 x 64), where the JAX package's carry its Pallas
  kernel's (128 x 128): rows from equal tables differ in ``p_blk`` and
  ``n_blk`` and in nothing else.

Rows are plain JSON-able dicts (``schema`` =
:data:`TRAINING_ROW_SCHEMA`) so the :class:`~repro_torch.store.ProfileStore`
can accumulate them across runs, models and fingerprints
(``save_training_rows``); :func:`training_rows_from_table` extracts
them from any profiled :class:`~repro_torch.core.profiler.ProfileTable`
whose model specs are in hand.

Regression targets are fit in log space, so features are logs of the
multiplicative shape terms plus binary aspect indicators —
:func:`feature_vector` for kernel times, :func:`boundary_features`
for the per-direction transfer costs.  :func:`group_key` names the
regression group a row trains: one weight vector per (geometry class,
placement, analytic kind), the granularity at which the cost surface
is close to a power law.
"""

from __future__ import annotations

import math

from repro_torch.bnn.layers import LayerSpec
from repro_torch.core.cost_model import gemm_dims_for, variant_analytics
from repro_torch.core.parallel_config import CONFIGS, aspects_of, is_host_config
from repro_torch.kernels.xnor_popcount import N_BLK, P_BLK

TRAINING_ROW_SCHEMA = 1


def layer_geometry(spec: LayerSpec, batch: int) -> dict:
    """The layer's dispatch shape at `batch`, as a JSON-able dict.

    conv/fc layers report their packed xnor-GEMM dims (``cls="gemm"``:
    b, p, n, kw plus operand/result byte counts); mp/step/flat layers
    report their element count (``cls="ew"``).  Byte counts feed the
    boundary-cost features — the same operand/result sizing the
    analytic cost model's transfer terms use.
    """
    dims = gemm_dims_for(spec, batch)
    if dims is not None:
        return {
            "cls": "gemm",
            "b": int(dims.b),
            "p": int(dims.p),
            "n": int(dims.n),
            "kw": int(dims.kw),
            "in_bytes": int(dims.a_bytes),
            "out_bytes": int(dims.o_bytes),
        }
    elems = int(batch)
    for d in spec.in_shape:
        elems *= int(d)
    return {
        "cls": "ew",
        "b": int(batch),
        "elems": elems,
        "in_bytes": elems * 4,
        "out_bytes": elems * 4,
    }


def _aspects(config: str, registry) -> tuple:
    if registry is not None and config not in CONFIGS and config in registry:
        return tuple(registry.get(config).aspects)
    return aspects_of(config)


def variant_meta(config: str, registry=None) -> dict:
    """Registry metadata for `config`, as a JSON-able dict: placement
    ("host"/"device"), analytic kind ("host"/"tiled"/"fused"), tile
    sizes and the aspect letters.  Raises on unknown names, exactly
    like the placement authority — a typo must not train a group."""
    p_blk, n_blk, analytic = variant_analytics(config, registry)
    host = is_host_config(config, registry)
    aspects = _aspects(config, registry)
    return {
        "config": config,
        "placement": "host" if host else "device",
        "analytic": analytic,
        "p_blk": int(p_blk),
        "n_blk": int(n_blk),
        "aspects": "".join(aspects) or "-",
    }


def group_key(geometry: dict, meta: dict) -> str:
    """The regression group a row belongs to — one fitted weight
    vector per (geometry class, placement, analytic kind)."""
    return f"{geometry['cls']}/{meta['placement']}/{meta['analytic']}"


def _log(v) -> float:
    return math.log(max(float(v), 1.0))


def feature_vector(geometry: dict, meta: dict) -> tuple:
    """Log-space features for a kernel-time regression row.  GEMM rows
    carry the shape and tile logs plus per-aspect indicators (what
    separates X from XYZ at identical shape); elementwise rows carry
    batch and element count only."""
    if geometry["cls"] == "gemm":
        a = meta.get("aspects", "-")
        return (
            1.0,
            _log(geometry["b"]),
            _log(geometry["p"]),
            _log(geometry["n"]),
            _log(geometry["kw"]),
            _log(meta.get("p_blk", P_BLK)),
            _log(meta.get("n_blk", N_BLK)),
            1.0 if "X" in a else 0.0,
            1.0 if "Y" in a else 0.0,
            1.0 if "Z" in a else 0.0,
        )
    return (1.0, _log(geometry["b"]), _log(geometry["elems"]))


def boundary_features(geometry: dict, direction: str) -> tuple:
    """Log-space features for an ``"h2d"``/``"d2h"`` boundary-cost
    row: batch and the bytes crossing the link in that direction."""
    bytes_ = (
        geometry["in_bytes"] if direction == "h2d"
        else geometry["out_bytes"]
    )
    return (1.0, _log(geometry["b"]), _log(bytes_))


def training_rows_from_table(model, table, registry=None) -> list:
    """Extract every (layer, batch, config) measurement in `table` as
    a training row.  Needs the model's specs in hand (geometry is not
    recoverable from the stored labels), so extraction happens where
    profiling does — ``ProfileStore.get_or_profile`` records rows for
    each table it profiles.  Config names the current registry cannot
    resolve (legacy tables) are skipped, not guessed at."""
    rows: list = []
    specs = tuple(getattr(model, "specs", ()))
    if len(specs) != len(table.layer_labels):
        return rows
    for b in table.batch_sizes:
        for i, spec in enumerate(specs):
            geometry = layer_geometry(spec, b)
            h2d_s = float(table.h2d(b, i))
            d2h_s = float(table.d2h(b, i))
            for cfg in table.configs_for(b, i):
                try:
                    meta = variant_meta(cfg, registry)
                except (KeyError, ValueError):
                    continue
                rows.append(
                    {
                        "schema": TRAINING_ROW_SCHEMA,
                        "model": table.model_name,
                        "layer": int(i),
                        "batch": int(b),
                        "config": cfg,
                        "geometry": geometry,
                        "meta": meta,
                        "kernel_s": float(table.kernel_time(b, i, cfg)),
                        "h2d_s": h2d_s,
                        "d2h_s": d2h_s,
                    }
                )
    return rows
