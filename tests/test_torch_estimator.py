"""The port's estimator (``repro_torch.estimator``) against the JAX
package's, on the same NumPy-made inputs.

Equal, not within a tolerance: layer geometry, feature vectors and
boundary features; the training rows of the same table apart from the
fixed 8's tile fields (``p_blk``/``n_blk`` 64 in the port, 128 in the
JAX package, by design); a ``LatencyPredictor`` fitted on the same rows
(its JSON) and the table it predicts (kernel rows priced from the
port's own metadata, which the test feeds to the reference predictor
too); ``fit_gamma``, ``FittedInterference`` and ``InterferenceFit`` on
the observations of ``fixtures.planted_gamma_ledger``, harvested by
the port from its own ``DeviceTimeLedger``.  Mirrors
``tests/test_estimator.py``."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import fixtures  # noqa: E402
from fixtures import (  # noqa: E402
    loglinear_table,
    planted_gamma_ledger,
    synthetic_model,
    truth_kernel_s,
)

from repro import estimator as R_E  # noqa: E402
from repro.bnn import models as R_M  # noqa: E402
from repro_torch import estimator as T_E  # noqa: E402
from repro_torch import fleet as T_F  # noqa: E402
from repro_torch.bnn import models as T_M  # noqa: E402
from repro_torch.core import cost_model as T_cm  # noqa: E402
from repro_torch.core import mapper as T_map  # noqa: E402
from repro_torch.core.mapper import DEVICE, HOST  # noqa: E402
from repro_torch.core.parallel_config import CONFIGS, CPU, FULL_GPU  # noqa: E402
from repro_torch.core.profiler import ProfileTable  # noqa: E402
from repro_torch.kernels.registry import DEFAULT_REGISTRY, GemmShape  # noqa: E402

TILE_FIELDS = ("p_blk", "n_blk")
TRAIN = (("train_a", (32, 64), (128, 10)), ("train_b", (48,), (256, 64, 10)),
         ("train_c", (16, 32, 64), (32, 10)))


def _models():
    out = {f"syn_{i}": (m, m) for i, m in enumerate(
        synthetic_model(n, conv_units=c, fc_units=f) for n, c, f in TRAIN)}
    for arch in ("cifar10", "fashion_mnist"):
        out[arch] = (R_M.build_model(arch), T_M.build_model(arch))
    return out


MODELS = _models()


def _without_tiles(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in TILE_FIELDS}


def _rows(model, batches=(1, 2, 4, 8)):
    """(reference rows, port rows) of the same loglinear table."""
    table = loglinear_table(model, batches)
    port_table = ProfileTable.from_json(table.to_json())
    return (R_E.training_rows_from_table(model, table),
            T_E.training_rows_from_table(model, port_table))


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("batch", (1, 4, 16))
def test_layer_geometry_equal_to_reference(name, batch):
    r, t = MODELS[name]
    for rs, ts in zip(r.specs, t.specs):
        assert T_E.layer_geometry(ts, batch) == R_E.layer_geometry(rs, batch)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_variant_meta_differs_only_in_the_tiles(cfg):
    got, want = T_E.variant_meta(cfg), R_E.variant_meta(cfg)
    assert _without_tiles(got) == _without_tiles(want)
    assert (got["p_blk"], got["n_blk"]) == (64, 64)
    assert (want["p_blk"], want["n_blk"]) == (128, 128)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_feature_vectors_equal_to_reference(name):
    """The same geometry and the same meta dict give equal features in
    both packages, whichever package made the meta."""
    r, t = MODELS[name]
    for rs, ts in zip(r.specs, t.specs):
        geom = T_E.layer_geometry(ts, 4)
        for cfg in CONFIGS:
            for meta in (T_E.variant_meta(cfg), R_E.variant_meta(cfg)):
                assert T_E.feature_vector(geom, meta) == (
                    R_E.feature_vector(geom, meta))
                assert T_E.group_key(geom, meta) == R_E.group_key(geom, meta)
        for direction in ("h2d", "d2h"):
            assert T_E.boundary_features(geom, direction) == (
                R_E.boundary_features(geom, direction))


def test_feature_vector_defaults_to_the_ports_tiles():
    geom = T_E.layer_geometry(MODELS["cifar10"][1].specs[0], 4)
    meta = {k: v for k, v in T_E.variant_meta("XYZ").items()
            if k not in TILE_FIELDS}
    assert T_E.feature_vector(geom, meta) == T_E.feature_vector(
        geom, T_E.variant_meta("XYZ"))
    assert T_E.feature_vector(geom, meta)[5:7] == (math.log(64),) * 2


@pytest.mark.parametrize("name", sorted(MODELS)[2:])
def test_training_rows_equal_apart_from_the_tiles(name):
    model = MODELS[name][0]
    want, got = _rows(model)
    assert len(got) == len(want) == 4 * len(model.specs) * len(CONFIGS)
    for g, w in zip(got, want):
        assert _without_tiles(g["meta"]) == _without_tiles(w["meta"])
        assert {**g, "meta": None} == {**w, "meta": None}
    assert json.loads(json.dumps(got)) == got
    other = synthetic_model("other", conv_units=(16,))
    assert T_E.training_rows_from_table(
        other, ProfileTable.from_json(loglinear_table(model).to_json())) == []


# ---------------------------------------------------------------------------
# latency predictor
# ---------------------------------------------------------------------------


def _training_rows():
    rows = []
    for name in ("syn_0", "syn_1", "syn_2"):
        rows += _rows(MODELS[name][0])[0]
    return rows


ROWS = _training_rows()


@pytest.mark.parametrize("kwargs", [{}, {"ridge": 1e-3}, {"min_rows": 50}])
def test_predictor_fit_json_equal_to_reference(kwargs):
    got = T_E.LatencyPredictor(**kwargs).fit(ROWS)
    want = R_E.LatencyPredictor(**kwargs).fit(ROWS)
    assert got.to_json() == want.to_json()
    assert got.coverage() == want.coverage()
    back = T_E.LatencyPredictor.from_json(want.to_json())
    assert back.to_json() == want.to_json()


@pytest.mark.parametrize("batches", [(1, 4), (3,), (16, 2)])
def test_predict_table_equal_to_reference(batches):
    """Boundary rows and elementwise rows are equal outright; GEMM rows
    equal the reference predictor's price for the port's own meta (the
    one stated difference)."""
    port = T_E.LatencyPredictor().fit(ROWS)
    ref = R_E.LatencyPredictor().fit(ROWS)
    held = synthetic_model("held", conv_units=(24, 40), fc_units=(96, 10))
    got = port.predict_table(held, batches)
    want = ref.predict_table(held, batches)
    assert got.provenance == want.provenance == "predicted"
    assert (got.batch_sizes, got.layer_labels) == (
        want.batch_sizes, want.layer_labels)
    assert got.h2d_times == want.h2d_times
    assert got.d2h_times == want.d2h_times
    for b in got.batch_sizes:
        for i, spec in enumerate(held.specs):
            geom = T_E.layer_geometry(spec, b)
            for cfg in CONFIGS:
                k = got.kernel_time(b, i, cfg)
                assert k == ref.predict_kernel_s(geom, T_E.variant_meta(cfg))
                if geom["cls"] == "ew":
                    assert k == want.kernel_time(b, i, cfg)
                assert got.times[b][i][cfg] == (
                    k if cfg == CPU else k + got.h2d(b, i) + got.d2h(b, i))


def test_predictor_recovers_loglinear_truth_on_held_out_model():
    pred = T_E.LatencyPredictor().fit(ROWS)
    held = synthetic_model("held_out", conv_units=(24, 40), fc_units=(96, 10))
    errs = []
    for b in (1, 3, 4):
        for spec in held.specs:
            geom = T_E.layer_geometry(spec, b)
            for cfg in CONFIGS:
                truth = truth_kernel_s(geom, R_E.variant_meta(cfg))
                got = pred.predict_kernel_s(geom, R_E.variant_meta(cfg))
                errs.append(abs(got - truth) / truth)
    assert max(errs) < 0.05


def test_predict_table_with_registry_adds_the_tile_variants():
    """With the default registry, GEMM rows widen to the tile variants
    that apply on the card (``platform=None`` prices the card); the DP
    maps the widened table."""
    pred = T_E.LatencyPredictor().fit(ROWS)
    model = MODELS["cifar10"][1]
    table = pred.predict_table(model, (1, 16), registry=DEFAULT_REGISTRY)
    seen = set()
    for b in (1, 16):
        for i, spec in enumerate(model.specs):
            row = table.configs_for(b, i)
            assert row[:len(CONFIGS)] == CONFIGS
            geom = T_E.layer_geometry(spec, b)
            if geom["cls"] != "gemm":
                assert row == CONFIGS
                continue
            shape = GemmShape(b, geom["p"], geom["n"], geom["kw"])
            assert row[len(CONFIGS):] == tuple(
                v.name for v in DEFAULT_REGISTRY.applicable(shape, "cuda")
                if v.name not in CONFIGS)
            seen |= set(row[len(CONFIGS):])
            for c in row:
                assert 0.0 < table.times[b][i][c] < 1e6
    assert seen == {"cuda_p16n64", "cuda_p32n64", "cuda_p64n32"}
    ec = T_map.map_efficient_configuration(table, policy="dp")
    assert ec.expected_time_per_example > 0.0


def test_predictor_fallbacks_and_validation():
    cold = T_E.LatencyPredictor()
    geom = T_E.layer_geometry(MODELS["syn_0"][1].specs[0], 4)
    meta = T_E.variant_meta(FULL_GPU)
    assert cold.predict_kernel_s(geom, meta) == R_E.LatencyPredictor(
    ).predict_kernel_s(geom, meta)
    assert cold.predict_boundary_s(geom, "h2d") == 0.0
    junk = [dict(ROWS[0], kernel_s=0.0), dict(ROWS[0], kernel_s=-1.0)]
    assert T_E.LatencyPredictor().fit(junk).n_rows == 0
    with pytest.raises(ValueError):
        T_E.LatencyPredictor(ridge=0.0)
    with pytest.raises(ValueError):
        T_E.LatencyPredictor(min_rows=0)
    doc = json.loads(T_E.LatencyPredictor().to_json())
    doc["kind"] = "profile_table"
    with pytest.raises(ValueError, match="latency_predictor"):
        T_E.LatencyPredictor.from_json(json.dumps(doc))


# ---------------------------------------------------------------------------
# interference: planted-gamma ledgers
# ---------------------------------------------------------------------------


LEDGERS = [(0.8, 0.0, 0), (0.3, 0.05, 1), (1.5, 0.1, 2), (0.0, 0.0, 3)]


def _observations(gamma, noise, seed):
    """The planted-gamma trace in the reference's ledger, the same
    closed steps replayed into the port's own ledger, and the solo
    expectations that decode them."""
    ledger, expected = planted_gamma_ledger(gamma, noise=noise, seed=seed)
    port = T_F.DeviceTimeLedger(window=ledger.window)
    for tenant in ledger.tenants():
        for host_s, dev_s in ledger.step_rows(tenant):
            port.record(tenant, HOST, host_s)
            port.record(tenant, DEVICE, dev_s)
            port.close_step(tenant)
    assert port.snapshot() == ledger.snapshot()
    return port, ledger, expected


@pytest.mark.parametrize("gamma,noise,seed", LEDGERS)
def test_interference_fit_equal_to_reference(gamma, noise, seed):
    port, ledger, expected = _observations(gamma, noise, seed)
    got = T_E.InterferenceFit.from_ledger(port, expected)
    want = R_E.InterferenceFit.from_ledger(ledger, expected)
    assert len(got) == len(want) > 0
    assert [vars(o) for o in got.observations()] == [
        vars(o) for o in want.observations()]
    assert T_E.fit_gamma(got.observations()) == R_E.fit_gamma(
        want.observations())
    for refine in (True, False):
        law, ref_law = got.fit(refine=refine), want.fit(refine=refine)
        assert law.to_json() == ref_law.to_json()
        for s in np.linspace(0.0, 3.0, 31):
            assert law.inflation(s) == ref_law.inflation(s)
            assert T_cm.contention_inflation(s, law=law) == (
                law.inflation(s))
        back = T_E.FittedInterference.from_json(ref_law.to_json())
        assert back == law
    if noise == 0.0:
        assert got.fit().gamma == pytest.approx(gamma, abs=1e-9)


def test_fitted_law_contract_and_validation():
    law = T_E.FittedInterference(gamma=0.5, knots=((0.2, 1.3), (0.5, 1.3),
                                                   (1.0, 1.9)))
    ref = R_E.FittedInterference(gamma=0.5, knots=law.knots)
    shares = np.linspace(0.0, 2.0, 41)
    vals = [law.inflation(s) for s in shares]
    assert vals == [ref.inflation(s) for s in shares]
    assert vals[0] == 1.0 and min(vals) >= 1.0
    assert all(a <= b for a, b in zip(vals, vals[1:]))
    with pytest.raises(ValueError):
        T_E.FittedInterference(gamma=-0.1)
    fit = T_E.InterferenceFit()
    fit.observe(-0.1, 2.0)
    fit.observe(0.5, 0.0)
    assert len(fit) == 0 and fit.fit().gamma == 0.0


@pytest.mark.parametrize("seed", range(4))
def test_random_observations_fit_equal_to_reference(seed):
    rng = np.random.default_rng(seed)
    got, want = T_E.InterferenceFit(), R_E.InterferenceFit()
    for s, f in zip(rng.uniform(0.0, 2.0, 40), rng.uniform(0.8, 3.0, 40)):
        got.observe(float(s), float(f), placement="device")
        want.observe(float(s), float(f), placement="device")
    assert got.fit().to_json() == want.fit().to_json()
    assert got.fit(max_knots=3).to_json() == want.fit(max_knots=3).to_json()


def test_fixtures_truth_weights_need_no_tile_feature():
    """The loglinear truth puts zero weight on the tile features, so
    the fixtures' tables are the same whichever package prices them."""
    for key, w in fixtures.TRUTH_WEIGHTS.items():
        if key.startswith("gemm"):
            assert w[5] == w[6] == 0.0
