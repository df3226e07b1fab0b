"""The port's core (profiler table, mapper, plan, executor) against the
JAX package: one ``ProfileTable`` JSON in must give the same
``EfficientConfiguration`` and plan JSON out of both packages; tables
round-trip across them both ways; a measured profile runs on CPU
tensors; and every plan shape executes bit-exactly against the JAX
package's ``forward_packed``."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import fixtures  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.bnn import models as R_M  # noqa: E402
from repro.core import mapper as R_map  # noqa: E402
from repro.core import plan as R_plan  # noqa: E402
from repro.core import profiler as R_prof  # noqa: E402
from repro_torch.bnn import models as T_M  # noqa: E402
from repro_torch.core import cost_model as T_cm  # noqa: E402
from repro_torch.core import mapper as T_map  # noqa: E402
from repro_torch.core import plan as T_plan  # noqa: E402
from repro_torch.core import profiler as T_prof  # noqa: E402
from repro_torch.core.mapped_model import (  # noqa: E402
    build_mapped_model,
    build_node_fns,
    build_segment_fns,
    run_plan,
)
from repro_torch.core.parallel_config import (  # noqa: E402
    CONFIGS,
    aspects_of,
    is_host_config,
    validate,
)

POLICIES = ("greedy", "dp")


def _labels(model):
    return tuple(f"L{s.idx}:{s.notation}" for s in model.specs)


def _random_model_table(arch, seed, batches=(1, 4)):
    """A random kernel/boundary-split table over a real model's layer
    labels (so plans chain), built by the JAX package's fixtures."""
    m = R_M.build_model(arch, scale=0.25)
    t = fixtures.random_split_table(
        np.random.default_rng(seed), n_layers=len(m.specs),
        batches=batches, name=m.name)
    return dataclasses.replace(t, layer_labels=_labels(m))


def _tables():
    out = {}
    for seed in range(3):
        out[f"random{seed}"] = fixtures.random_split_table(
            np.random.default_rng(seed), n_layers=6, batches=(1, 4, 16))
    out["tied"] = fixtures.tied_table("tied")
    out["loglinear"] = fixtures.loglinear_table(
        fixtures.synthetic_model("syn"))
    for arch in ("cifar10", "fashion_mnist"):
        out[f"flat_{arch}"] = fixtures.flat_table(
            R_M.build_model(arch, scale=0.25))
        out[f"model_{arch}"] = _random_model_table(arch, 7)
    return out


TABLES = _tables()
PLANNABLE = [k for k in TABLES if k.startswith(("flat_", "model_"))]


def _port(table):
    return T_prof.ProfileTable.from_json(table.to_json())


# ---------------------------------------------------------------------------
# ProfileTable JSON
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(TABLES))
def test_profile_table_json_round_trips_both_ways(name):
    ref = TABLES[name]
    ref.segment_times = None
    port = _port(ref)
    assert port.to_json() == ref.to_json()
    assert R_prof.ProfileTable.from_json(port.to_json()) == ref
    port.add_segment_row(ref.batch_sizes[0], 0, 2, {"seg_cuda": 1e-6})
    back = R_prof.ProfileTable.from_json(port.to_json())
    assert back.segment_time(ref.batch_sizes[0], 0, 2, "seg_cuda") == 1e-6
    assert _port(back) == port


def test_profile_table_refuses_newer_schema_and_other_kinds():
    doc = json.loads(TABLES["tied"].to_json())
    with pytest.raises(ValueError, match="newer"):
        T_prof.ProfileTable.from_json(json.dumps({**doc, "schema": 2}))
    with pytest.raises(ValueError, match="profile_table"):
        T_prof.ProfileTable.from_json(json.dumps({**doc, "kind": "x"}))
    legacy = {k: doc[k] for k in ("model", "batch_sizes", "layer_labels",
                                  "times")}
    t = T_prof.ProfileTable.from_json(json.dumps(legacy))
    assert t.kernel_time(4, 0, "X") == t.times[4][0]["X"]
    assert t.h2d(4, 0) == 0.0


# ---------------------------------------------------------------------------
# mapper and plan parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(TABLES))
@pytest.mark.parametrize("policy", POLICIES)
def test_mapping_json_equals_reference(name, policy):
    ref = TABLES[name]
    want = R_map.map_efficient_configuration(ref, policy=policy)
    got = T_map.map_efficient_configuration(_port(ref), policy=policy)
    assert got.to_json() == want.to_json()
    assert got.segment_expected_times() == want.segment_expected_times()
    assert got.stage_times() == want.stage_times()
    for n in (1, 4):
        assert got.pipelined_expected_time(n) == want.pipelined_expected_time(n)
    assert len(got.segments()) == len(want.segments())


@pytest.mark.parametrize("name", sorted(TABLES))
def test_dp_never_worse_than_greedy(name):
    t = _port(TABLES[name])
    dp = T_map.map_efficient_configuration(t, policy="dp")
    greedy = T_map.map_efficient_configuration(t, policy="greedy")
    assert dp.expected_time_per_example <= greedy.expected_time_per_example


@pytest.mark.parametrize("name", PLANNABLE)
@pytest.mark.parametrize("mode", ["segments", "layers", "roundtrip", "whole"])
@pytest.mark.parametrize("policy", POLICIES)
def test_plan_json_equals_reference(name, mode, policy):
    ref = TABLES[name]
    r_ec = R_map.map_efficient_configuration(ref, policy=policy)
    t_ec = T_map.EfficientConfiguration.from_json(r_ec.to_json())
    want = R_plan.build_plan(r_ec, mode=mode)
    got = T_plan.build_plan(t_ec, mode=mode)
    assert got.to_json() == want.to_json()
    assert T_plan.boundary_encoding_changes(got) == ()
    assert T_plan.encoding_conversions(got) == R_plan.encoding_conversions(want)
    assert T_plan.SegmentPlan.from_json(got.to_json()) == got


def test_price_mapping_equals_reference():
    ref = TABLES["model_cifar10"]
    rng = np.random.default_rng(0)
    for _ in range(5):
        mapping = tuple(rng.choice(CONFIGS, len(ref.layer_labels)))
        want = R_map.price_mapping(ref, 4, mapping)
        assert T_map.price_mapping(_port(ref), 4, mapping).to_json() == (
            want.to_json())
    with pytest.raises(ValueError):
        T_map.price_mapping(_port(ref), 8, mapping)


def test_legacy_fixed8_json_loads_and_reserializes_like_the_reference():
    doc = json.dumps({
        "model": "fashion_mnist", "proper_batch_size": 8,
        "layers": [{"layer": f"L{i + 1}:C64", "config": c,
                    "time_per_example": 1e-4 * (i + 1)}
                   for i, c in enumerate(("CPU", "X", "XYZ", "YZ"))],
        "expected_time_per_example": 1e-3,
    })
    want = R_map.EfficientConfiguration.from_json(doc)
    got = T_map.EfficientConfiguration.from_json(doc)
    assert got.policy == "greedy" and got.config_space == ()
    assert got.to_json() == want.to_json()
    assert [validate(c) for c in got.layer_configs] == list(got.layer_configs)
    assert [aspects_of(c) for c in got.layer_configs] == [
        (), ("X",), ("X", "Y", "Z"), ("Y", "Z")]


def test_placement_authority():
    assert is_host_config("CPU") and not is_host_config("XZ")
    assert not is_host_config("seg_cuda")
    for bad in ("xla_fused", "pallas_p64n64", "cpu"):
        with pytest.raises(ValueError):
            is_host_config(bad)


def test_cost_model_algebra_equals_reference():
    from repro.core import cost_model as R_cm

    ec = R_map.map_efficient_configuration(TABLES["model_cifar10"],
                                           policy="greedy")
    k, b = ec.per_layer_kernel_times, ec.per_layer_boundary_times
    assert T_cm.segment_times_from_split(ec.segments(), k, b) == (
        R_cm.segment_times_from_split(ec.segments(), k, b))
    for h, d, n in ((1.0, 2.0, 5), (3.0, 0.5, 1), (1.0, 1.0, 0)):
        assert T_cm.pipeline_makespan(h, d, n) == R_cm.pipeline_makespan(h, d, n)


def test_fused_selection_takes_only_registered_cheaper_variants():
    t = _port(TABLES["flat_cifar10"])
    ec = T_map.price_mapping(t, 4, ("CPU",) + ("XYZ",) * 18)
    assert T_plan.device_spans(ec) == ((1, 19),)
    s, e = 1, 19
    t.add_segment_row(4, s, e, {"seg_pallas": 1e-12, "seg_cuda": 2e-9})
    fused = T_plan.select_fused_segments(ec, t)
    assert fused.fused_segments == ((s, e, "seg_cuda", 2e-9),)
    per_layer = T_plan.build_plan(ec).expected_time_per_example
    assert T_plan.build_plan(fused).expected_time_per_example <= per_layer
    t.add_segment_row(4, s, e, {"seg_cuda": 1.0})
    assert T_plan.select_fused_segments(ec, t).fused_segments == ()


# ---------------------------------------------------------------------------
# measured profiling on CPU tensors
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    m = T_M.build_model("fashion_mnist", scale=0.25)
    fp = T_M.random_fp_params(m.specs, 0)
    packed = T_M.pack_params(m.specs, fp, device="cpu")
    table = T_prof.profile_bnn_model(
        m, packed, batch_sizes=(1, 2), repeats=1, device="cpu")
    return m, fp, packed, table


def test_measured_profile_runs_on_cpu_tensors(small):
    m, _, _, table = small
    assert table.provenance == "measured"
    assert table.layer_labels == _labels(m)
    for b in (1, 2):
        for i in range(len(m.specs)):
            assert table.configs_for(b, i) == CONFIGS
            for c in CONFIGS:
                k = table.kernel_time(b, i, c)
                assert k > 0
                want = k if c == "CPU" else k + table.h2d(b, i) + table.d2h(b, i)
                assert table.times[b][i][c] == want
    ref = R_prof.ProfileTable.from_json(table.to_json())
    for policy in POLICIES:
        assert T_map.map_efficient_configuration(table, policy=policy) \
            .to_json() == R_map.map_efficient_configuration(
                ref, policy=policy).to_json()


def test_measured_segment_rows_and_fuse_mapping(small):
    m, _, packed, table = small
    table = T_prof.ProfileTable.from_json(table.to_json())
    ec = T_map.price_mapping(table, 2, ("XYZ",) * len(m.specs))
    fused = T_plan.fuse_mapping(m, packed, table, ec, repeats=1, device="cpu")
    assert table.segment_variants_for(2, 0, len(m.specs)) == ("seg_cuda",)
    assert table.segment_time(2, 0, len(m.specs), "seg_cuda") > 0
    assert fused.layer_configs == ec.layer_configs


def test_measured_autotune_on_cpu_tensors(small):
    """The reference's measured-autotune invariants on CPU tensors: the
    fixed 8 in every row and never pruned, elementwise rows exactly the
    fixed 8, tile variants where they apply, autotuned DP <= fixed-8."""
    m, _, packed, _ = small
    table = T_prof.autotune_bnn_model(m, packed, batch_sizes=(1,),
                                      repeats=1, device="cpu")
    assert table.provenance == "measured"
    extended = set()
    for b in (1,):
        for i, spec in enumerate(m.specs):
            row = table.configs_for(b, i)
            assert row[:len(CONFIGS)] == CONFIGS
            if spec.kind in ("conv", "fc"):
                extended |= set(row[len(CONFIGS):])
            else:
                assert row == CONFIGS
            for c in row:
                assert table.kernel_time(b, i, c) > 0
    assert extended and extended <= {"cuda_p16n64", "cuda_p32n64",
                                     "cuda_p64n32"}
    for policy in POLICIES:
        full = T_map.map_efficient_configuration(table, policy=policy)
        fixed = T_map.map_efficient_configuration(table, policy=policy,
                                                  configs=CONFIGS)
        assert full.expected_time_per_example <= (
            fixed.expected_time_per_example)


def test_measured_autotune_prunes_only_extended_variants(small):
    m, _, packed, _ = small
    table = T_prof.autotune_bnn_model(m, packed, batch_sizes=(1,),
                                      repeats=1, prune_factor=1e-9,
                                      device="cpu")
    for i in range(len(m.specs)):
        assert table.configs_for(1, i) == CONFIGS


@pytest.mark.parametrize("time_source", ["analytic", "measured"])
def test_autotune_platform_follows_the_time_source(small, time_source):
    """Analytic mode prices the card (tile variants at every size);
    measured mode on CPU tensors gates them by the plain version's
    work cap."""
    m, _, packed, _ = small
    big = T_M.build_model("fashion_mnist")
    bp = T_M.pack_params(big.specs, T_M.random_fp_params(big.specs, 0),
                         device="cpu")
    if time_source == "analytic":
        t = T_prof.autotune_bnn_model(big, bp, batch_sizes=(16,),
                                      time_source="analytic")
        assert "cuda_p16n64" in t.configs_for(16, 0)
    else:
        shape = T_prof.gemm_shape_of(big.specs[0], bp[0], 16)
        from repro_torch.kernels.registry import DEFAULT_REGISTRY

        assert not DEFAULT_REGISTRY.get("cuda_p16n64").applies_to(
            shape, "cpu")
        assert DEFAULT_REGISTRY.get("cuda_p16n64").applies_to(shape, "cuda")


def test_analytic_segment_rows_and_fuse_mapping(small):
    m, _, packed, _ = small
    table = T_prof.profile_bnn_model(m, packed, batch_sizes=(1, 2),
                                     time_source="analytic")
    assert table.provenance == "analytic"
    ec = T_map.map_efficient_configuration(table, policy="dp")
    fused = T_plan.fuse_mapping(m, packed, table, ec,
                                time_source="analytic")
    b = ec.proper_batch_size
    for s, e in T_plan.device_spans(ec):
        t = table.segment_time(b, s, e, "seg_cuda")
        assert t == T_cm.fused_segment_kernel_time_h100(m.specs[s:e], b) / b
        assert t <= sum(ec.per_layer_kernel_times[s:e])
    assert T_plan.build_plan(fused).expected_time_per_example <= (
        T_plan.build_plan(ec).expected_time_per_example)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_baselines_and_placement_shares_equal_reference(name):
    ref = TABLES[name]
    port = _port(ref)
    for b in ref.batch_sizes:
        for cfg in CONFIGS:
            assert T_map.uniform_total(port, cfg, b) == (
                R_map.uniform_total(ref, cfg, b))
    for cfg in CONFIGS:
        assert T_map.best_uniform(port, cfg) == R_map.best_uniform(ref, cfg)
    for policy in POLICIES:
        got = T_map.map_efficient_configuration(port, policy=policy)
        want = R_map.map_efficient_configuration(ref, policy=policy)
        assert got.placement_shares() == want.placement_shares()
        h, d = got.placement_shares()
        assert h + d == pytest.approx(1.0) or (h, d) == (0.0, 0.0)
    with pytest.raises(ValueError):
        T_map.uniform_total(port, "nope", ref.batch_sizes[0])


def test_deprecated_shims_warn_once_per_site_and_delegate(small):
    from repro_torch import _compat

    m, _, packed, table = small
    table = T_prof.ProfileTable.from_json(table.to_json())
    mapping = ("XYZ",) * len(m.specs)
    _compat.reset_warned()
    with pytest.warns(DeprecationWarning, match="price_mapping"):
        got = T_map.configuration_from_mapping(table, 2, mapping)
    assert got.to_json() == T_map.price_mapping(table, 2, mapping).to_json()
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for _ in range(3):
            T_map.configuration_from_mapping(table, 2, mapping)
    assert len(seen) == 1
    with pytest.warns(DeprecationWarning, match="fuse_mapping"):
        fused = T_plan.fuse_configuration(m, packed, table, got,
                                          time_source="analytic")
    assert fused.fused_segments == T_plan.fuse_mapping(
        m, packed, table, got, time_source="analytic").fused_segments
    _compat.reset_warned()


# ---------------------------------------------------------------------------
# the one executor, bit-exact against the JAX package
# ---------------------------------------------------------------------------


_REF_OUT = {}


def _reference_output(arch):
    """(port model, port params, packed input, JAX forward_packed output)
    at scale 0.25, batch 2, computed once per architecture."""
    if arch not in _REF_OUT:
        r = R_M.build_model(arch, scale=0.25)
        fp = T_M.random_fp_params(r.specs, 3)
        x01 = np.random.default_rng(4).random(
            (2, *r.input_hw, r.in_channels), dtype=np.float32)
        want = np.asarray(R_M.forward_packed(
            r.specs, R_M.pack_params(r.specs, fp),
            R_M.prepare_input_packed(jnp.asarray(x01))))
        m = T_M.build_model(arch, scale=0.25)
        _REF_OUT[arch] = (
            m, T_M.pack_params(m.specs, fp, device="cpu"),
            T_M.prepare_input_packed(torch.from_numpy(x01)), want)
    return _REF_OUT[arch]


def _ec_for(model, mapping, fused_whole=False):
    table = fixtures.flat_table(model, batch=2)
    ec = T_map.price_mapping(_port(table), 2, mapping)
    if fused_whole:
        spans = T_plan.device_spans(ec)
        ec = dataclasses.replace(ec, fused_segments=tuple(
            (s, e, "seg_cuda", 1e-9) for s, e in spans))
    return ec


@settings(max_examples=12, deadline=None)
@given(arch=st.sampled_from(["cifar10", "fashion_mnist"]),
       seed=st.integers(0, 2**31 - 1),
       fused=st.booleans())
def test_every_plan_shape_is_bit_exact_vs_reference(arch, seed, fused):
    m, packed, x, want = _reference_output(arch)
    rng = np.random.default_rng(seed)
    mapping = tuple(rng.choice(CONFIGS, len(m.specs)))
    ec = _ec_for(m, mapping, fused_whole=fused)
    for kw in ({"fused": True}, {"fused": False, "elide_transfers": True},
               {"fused": False, "elide_transfers": False}):
        f = build_mapped_model(m, packed, ec, device="cpu", **kw)
        assert np.array_equal(f(x).numpy(), want), (mapping, kw)
    nodes = build_segment_fns(m, packed, ec, device="cpu")
    assert np.array_equal(run_plan(nodes, device="cpu")(x).numpy(), want)


def test_fused_segments_execute_through_the_segment_builder():
    m, packed, x, want = _reference_output("cifar10")
    ec = _ec_for(m, ("XYZ",) * len(m.specs), fused_whole=True)
    nodes = build_segment_fns(m, packed, ec, device="cpu")
    assert [n.fused_variant for n, _ in nodes] == ["seg_cuda"]
    assert np.array_equal(run_plan(nodes, device="cpu")(x).numpy(), want)


def test_layer_scope_variant_as_fused_is_rejected():
    m, packed, _, _ = _reference_output("fashion_mnist")
    ec = _ec_for(m, ("XYZ",) * len(m.specs))
    ec = dataclasses.replace(ec, fused_segments=((0, len(m.specs), "XYZ",
                                                  1e-9),))
    with pytest.raises(ValueError, match="scope"):
        build_node_fns(m, packed, ec, T_plan.build_plan(ec), device="cpu")


@pytest.mark.parametrize("arch", ["cifar10", "fashion_mnist"])
def test_autotuned_mapping_serves_bit_exact_vs_reference(arch):
    """An autotuned (analytic) DP mapping, and one that puts a tile
    variant on every GEMM layer, execute bit-exactly against the JAX
    package's forward_packed on CPU tensors, fused and per layer."""
    m, packed, x, want = _reference_output(arch)
    table = T_prof.autotune_bnn_model(m, packed, batch_sizes=(2,),
                                      time_source="analytic")
    dp = T_map.map_efficient_configuration(table, policy="dp")
    tiles = tuple(
        next((c for c in table.configs_for(2, i) if c.startswith("cuda_p")),
             "XYZ") if s.kind in ("conv", "fc") else "CPU"
        for i, s in enumerate(m.specs))
    assert any(c.startswith("cuda_p") for c in tiles)
    forced = T_map.price_mapping(table, 2, tiles)
    for ec in (dp, forced, T_plan.fuse_mapping(m, packed, table, dp,
                                               time_source="analytic")):
        for kw in ({"fused": True}, {"fused": False}):
            f = build_mapped_model(m, packed, ec, device="cpu", **kw)
            assert np.array_equal(f(x).numpy(), want), (ec.layer_configs, kw)
