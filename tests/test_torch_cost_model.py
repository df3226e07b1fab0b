"""The port's pricing (``repro_torch.core.cost_model``), its analytic
H100 model and the registry autotune sweep, against the JAX package.

Equal, not within a tolerance, from equal inputs: GEMM dims, GEMM
shapes, the loop-nest traffic of one variant registered with the same
tiles in both registries, the pruning decision, the contention pricing
(``contention_inflation``, ``inflate_profile`` as table JSON) and
``plan_node_times``.  By design the fixed 8 carry the port's own
kernel-1 tiles (64 x 64) where the JAX package's carry 128 x 128; the
tests say so rather than compare them.  The H100 model is held to the
reference model's invariants (grid order moves traffic, fused <= per
layer, the paper's placement claim), and the autotune sweep to the
reference's (rows contain the fixed 8, elementwise rows are the fixed
8, autotuned DP <= fixed-8 DP)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import fixtures  # noqa: E402

from repro.bnn import models as R_M  # noqa: E402
from repro.core import cost_model as R_cm  # noqa: E402
from repro.core import mapper as R_map  # noqa: E402
from repro.core import plan as R_plan  # noqa: E402
from repro.core import profiler as R_prof  # noqa: E402
from repro.kernels import registry as R_REG  # noqa: E402
from repro_torch.bnn import models as T_M  # noqa: E402
from repro_torch.core import cost_model as T_cm  # noqa: E402
from repro_torch.core import mapper as T_map  # noqa: E402
from repro_torch.core import plan as T_plan  # noqa: E402
from repro_torch.core import profiler as T_prof  # noqa: E402
from repro_torch.core.parallel_config import CONFIGS  # noqa: E402
from repro_torch.kernels import registry as T_REG  # noqa: E402
from repro_torch.kernels.xnor_popcount import (  # noqa: E402
    N_BLK,
    P_BLK,
    _fit_tile,
    aspect_mask,
    launch_plan,
)

ARCHS = ("cifar10", "fashion_mnist")
BATCHES = (1, 4, 16, 33)
TILES = ("cuda_p16n64", "cuda_p32n64", "cuda_p64n32")
ASPECTS = ("X", "Y", "Z", "XY", "XZ", "YZ", "XYZ")
DIMS = (
    (16, 1024, 64, 18), (1, 1024, 64, 9), (16, 256, 256, 72),
    (8, 64, 512, 144), (16, 1, 1024, 256), (1, 1, 10, 32), (3, 37, 21, 5),
)


def _models(arch):
    return R_M.build_model(arch), T_M.build_model(arch)


# ---------------------------------------------------------------------------
# GEMM dims and shapes: equal on both paper nets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batch", BATCHES)
def test_gemm_dims_for_equal_to_reference(arch, batch):
    r, t = _models(arch)
    for rs, ts in zip(r.specs, t.specs):
        rd, td = R_cm.gemm_dims_for(rs, batch), T_cm.gemm_dims_for(ts, batch)
        if rd is None:
            assert td is None
            continue
        assert dataclasses.astuple(td) == dataclasses.astuple(rd)
        assert (td.a_bytes, td.w_bytes, td.o_bytes, td.vpu_ops) == (
            rd.a_bytes, rd.w_bytes, rd.o_bytes, rd.vpu_ops)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batch", (1, 16))
def test_gemm_shape_of_equal_to_reference_and_cost_model(arch, batch):
    r, t = _models(arch)
    fp = T_M.random_fp_params(t.specs, 0)
    rp = R_M.pack_params(r.specs, fp)
    tp = T_M.pack_params(t.specs, fp, device="cpu")
    for rs, ts, a, b in zip(r.specs, t.specs, rp, tp):
        want = R_prof.gemm_shape_of(rs, a, batch)
        got = T_prof.gemm_shape_of(ts, b, batch)
        if want is None:
            assert got is None and T_cm.gemm_dims_for(ts, batch) is None
            continue
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        dims = T_cm.gemm_dims_for(ts, batch)
        assert (got.b, got.p, got.n, got.kw) == (
            dims.b, dims.p, dims.n, dims.kw)


# ---------------------------------------------------------------------------
# tiles: the port's own, and traffic parity on equal tiles
# ---------------------------------------------------------------------------


def test_fixed8_tiles_are_the_ports_own_by_design():
    """The fixed 8 price under kernel 1's 64 x 64 tile in the port and
    the Pallas kernel's 128 x 128 in the JAX package; nothing else of
    the metadata differs."""
    assert (P_BLK, N_BLK) == (64, 64)
    for cfg in CONFIGS:
        got = T_cm.variant_analytics(cfg)
        want = R_cm.variant_analytics(cfg)
        assert got == (64, 64, want[2])
        assert want[:2] == (128, 128)
    assert T_cm.variant_analytics("seg_cuda") == (64, 64, "fused")
    for name in TILES:
        v = T_REG.DEFAULT_REGISTRY.get(name)
        assert T_cm.variant_analytics(name) == (v.p_blk, v.n_blk, "tiled")


def _same_tiles(p_blk, n_blk, aspects=("X", "Y", "Z")):
    """One variant with the same tiles registered in a registry of each
    package."""
    name = f"same_p{p_blk}n{n_blk}_{''.join(aspects)}"
    regs = []
    for R in (R_REG, T_REG):
        reg = R.VariantRegistry()
        reg.register(R.KernelVariant(
            name=name, builder=None, placement="device",
            aspects=tuple(aspects), p_blk=p_blk, n_blk=n_blk,
            analytic="tiled"))
        regs.append(reg)
    return name, regs


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("tiles", [(64, 64), (128, 128), (16, 64), (32, 256)])
@pytest.mark.parametrize("aspects", ["XYZ", "X", "YZ", "Z"])
def test_gemm_hbm_traffic_equal_on_equal_tiles(dims, tiles, aspects):
    name, (r_reg, t_reg) = _same_tiles(*tiles, tuple(aspects))
    rd, td = R_cm.GemmDims(*dims), T_cm.GemmDims(*dims)
    assert T_cm.gemm_hbm_traffic(td, name, t_reg) == R_cm.gemm_hbm_traffic(
        rd, name, r_reg)
    assert T_cm._grid(td, name, t_reg) == R_cm._grid(rd, name, r_reg)


def test_grid_order_changes_traffic():
    dims = T_cm.GemmDims(b=16, p=1024, n=512, kw=72)
    traffic = {c: T_cm.gemm_hbm_traffic(dims, c) for c in ASPECTS}
    assert len(set(traffic.values())) > 1
    lo = dims.a_bytes + dims.w_bytes + dims.o_bytes
    assert all(t >= lo for t in traffic.values())
    tiles = {c: T_cm.gemm_hbm_traffic(dims, c) for c in TILES}
    assert len(set(tiles.values())) == len(TILES)


def _cifar_gemm_shapes():
    m = T_M.build_model("cifar10")
    return [(s.idx, T_cm.gemm_dims_for(s, b)) for b in (1, 16)
            for s in m.specs if s.kind in ("conv", "fc")]


@pytest.mark.parametrize("name", TILES)
def test_each_tile_variant_launches_differently_from_xyz(name):
    """Each tile variant's launch plan differs from XYZ's at some
    CIFAR-10 layer shape, and the variant applies exactly there."""
    v = T_REG.DEFAULT_REGISTRY.get(name)
    mask = aspect_mask(("X", "Y", "Z"))
    differs = 0
    for _, d in _cifar_gemm_shapes():
        own = launch_plan(d.b, d.p, d.n, d.kw, mask, _fit_tile(v.p_blk, d.p),
                          _fit_tile(v.n_blk, d.n))
        xyz = launch_plan(d.b, d.p, d.n, d.kw, mask, _fit_tile(P_BLK, d.p),
                          _fit_tile(N_BLK, d.n))
        assert T_cm.gemm_launch_plan(d, name) == own
        assert T_cm.gemm_launch_plan(d, "XYZ") == xyz
        shape = T_REG.GemmShape(d.b, d.p, d.n, d.kw)
        assert v.applies_to(shape, "cuda") == (own != xyz)
        differs += own != xyz
    assert differs > 0


def test_tile_variants_gate_on_the_cpu_by_work():
    big = T_REG.GemmShape(16, 1024, 64, 18)
    small = T_REG.GemmShape(1, 64, 64, 4)
    for name in TILES[:2]:
        v = T_REG.DEFAULT_REGISTRY.get(name)
        assert v.applies_to(big, "cuda") and not v.applies_to(big, "cpu")
        assert v.applies_to(small, "cpu")


# ---------------------------------------------------------------------------
# the analytic H100 model: the reference model's invariants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", DIMS)
def test_h100_times_positive_and_bounded_below(dims):
    d = T_cm.GemmDims(*dims)
    for cfg in CONFIGS + TILES:
        t = T_cm.gemm_kernel_time_h100(d, cfg)
        assert t > 0 and math.isfinite(t)
        if cfg != "CPU":
            plan = T_cm.gemm_launch_plan(d, cfg)
            assert t >= T_cm.LAUNCH_S + (d.a_bytes + d.w_bytes + d.o_bytes) / (
                T_cm.HBM_BW)
            assert T_cm.gemm_launch_bit_products(plan) >= 32 * d.b * d.p * (
                d.n * d.kw)
    assert T_cm.gemm_kernel_time_h100(d, "CPU") != (
        T_cm.gemm_kernel_time_h100(d, "XYZ"))
    h2d, d2h = T_cm.gemm_transfer_times_h100(d)
    assert h2d == T_cm.LAUNCH_S + d.a_bytes / T_cm.PCIE_BW
    assert d2h == T_cm.LAUNCH_S + d.o_bytes / T_cm.PCIE_BW


def test_h100_model_keeps_small_layers_on_host():
    """The reference model's claim on the H100 model: mp, step and flat
    layers are cheaper on the CPU at B 16, and some late conv is cheaper
    on the card at B 128."""
    m = T_M.build_model("cifar10", scale=0.5)
    small = [s for s in m.specs if s.kind in ("mp", "step", "flat")]
    big = [s for s in m.specs if s.kind == "conv"][2:]
    for s in small:
        t_cpu = T_cm.layer_time_h100(s, "CPU", batch=16)
        t_gpu = T_cm.layer_time_h100(s, "XYZ", batch=16)
        assert t_cpu < t_gpu, f"{s.notation}: cpu {t_cpu} gpu {t_gpu}"
    assert any(
        T_cm.layer_time_h100(s, "XYZ", batch=128)
        < T_cm.layer_time_h100(s, "CPU", batch=128) for s in big)


def test_layer_split_charges_transfers_only_on_the_card():
    m = T_M.build_model("cifar10")
    for s in m.specs:
        k, h2d, d2h = T_cm.layer_time_split_h100(s, "CPU", 4)
        assert k > 0 and h2d == d2h == 0.0
        k, h2d, d2h = T_cm.layer_time_split_h100(s, "XY", 4)
        assert k > 0 and h2d > 0 and d2h > 0
        assert T_cm.layer_time_h100(s, "XY", 4) == k + h2d + d2h


SPANS = {"cifar10": ((0, 19), (14, 19), (3, 10), (0, 2), (16, 19)),
         "fashion_mnist": ((0, 10), (1, 7), (7, 10))}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batch", (1, 16, 128))
def test_fused_segment_never_above_per_layer_sum(arch, batch):
    m = T_M.build_model(arch)
    for s, e in SPANS[arch]:
        specs = m.specs[s:e]
        fused = T_cm.fused_segment_kernel_time_h100(specs, batch)
        for cfg in ASPECTS + TILES:
            per_layer = sum(T_cm.layer_time_split_h100(sp, cfg, batch)[0]
                            for sp in specs)
            assert 0 < fused <= per_layer, (s, e, cfg)


# ---------------------------------------------------------------------------
# pruning, contention and plan times: equal to the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmups,factor", [
    ({"CPU": 5.0, "X": 1.0, "ext_ok": 2.9, "ext_slow": 3.1}, 3.0),
    ({"XYZ": 2e-6, "cuda_p16n64": 1e-6, "cuda_p64n32": 9e-6}, 3.0),
    ({"XYZ": 2e-6, "cuda_p16n64": 4e-6, "cuda_p64n32": 2.1e-6}, 1.0),
    ({}, 3.0),
])
def test_prune_survivors_equal_to_reference(warmups, factor):
    got = T_prof.prune_survivors(warmups, prune_factor=factor)
    assert got == R_prof.prune_survivors(warmups, prune_factor=factor)
    assert set(CONFIGS) & set(warmups) <= set(got)


@pytest.mark.parametrize("share", [0.0, 0.3, 1.0, 2.5, -1.0])
@pytest.mark.parametrize("gamma", [0.0, 0.5, 1.0, 2.0])
def test_contention_inflation_equal_to_reference(share, gamma):
    assert T_cm.contention_inflation(share, gamma) == (
        R_cm.contention_inflation(share, gamma))
    with pytest.raises(ValueError):
        T_cm.contention_inflation(share, -0.1)


def _tables():
    """Random kernel/boundary-split tables over each paper net's layer
    labels (so plans chain), and the tied table."""
    out = {"tied": fixtures.tied_table("tied")}
    for arch in ARCHS:
        m = R_M.build_model(arch, scale=0.25)
        labels = tuple(f"L{s.idx}:{s.notation}" for s in m.specs)
        for seed in range(2):
            t = fixtures.random_split_table(
                np.random.default_rng(seed), n_layers=len(m.specs),
                batches=(1, 4, 16), name=m.name)
            out[f"{arch}{seed}"] = dataclasses.replace(t, layer_labels=labels)
    return out


TABLES = _tables()
PLANNABLE = [k for k in TABLES if k != "tied"]


@pytest.mark.parametrize("name", sorted(TABLES))
@pytest.mark.parametrize("factors", [(1.0, 1.0), (1.5, 1.0), (1.0, 2.0),
                                     (0.7, 3.0)])
def test_inflate_profile_json_equal_to_reference(name, factors):
    ref = TABLES[name]
    port = T_prof.ProfileTable.from_json(ref.to_json())
    h, d = factors
    got = T_cm.inflate_profile(port, host_factor=h, device_factor=d)
    want = R_cm.inflate_profile(ref, host_factor=h, device_factor=d)
    assert got.to_json() == want.to_json()
    if factors == (1.0, 1.0):
        assert got is port
    with pytest.raises(ValueError):
        T_cm.inflate_profile(port, host_factor=0.0)


@pytest.mark.parametrize("name", PLANNABLE)
@pytest.mark.parametrize("policy", ["greedy", "dp"])
def test_plan_node_times_equal_to_reference(name, policy):
    ref = TABLES[name]
    port = T_prof.ProfileTable.from_json(ref.to_json())
    r_ec = R_map.map_efficient_configuration(ref, policy=policy)
    t_ec = T_map.map_efficient_configuration(port, policy=policy)
    got = T_cm.plan_node_times(T_plan.build_plan(t_ec))
    assert got == R_cm.plan_node_times(R_plan.build_plan(r_ec))
    assert math.isclose(sum(got), t_ec.expected_time_per_example,
                        rel_tol=1e-12)


# ---------------------------------------------------------------------------
# the analytic autotune sweep at full width
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def analytic_cifar():
    m = T_M.build_model("cifar10")
    packed = T_M.pack_params(m.specs, T_M.random_fp_params(m.specs, 0),
                             device="cpu")
    table = T_prof.autotune_bnn_model(m, packed, batch_sizes=(1, 4, 16),
                                      time_source="analytic")
    return m, packed, table


def test_analytic_autotune_rows_and_bound(analytic_cifar):
    m, _, table = analytic_cifar
    assert table.provenance == "analytic"
    seen = set()
    for b in table.batch_sizes:
        for i, spec in enumerate(m.specs):
            row = table.configs_for(b, i)
            if spec.kind in ("conv", "fc"):
                assert row[:len(CONFIGS)] == CONFIGS
                seen |= set(row[len(CONFIGS):])
            else:
                assert row == CONFIGS
    assert seen == set(TILES)
    for policy in ("dp", "greedy"):
        full = T_map.map_efficient_configuration(table, policy=policy)
        fixed = T_map.map_efficient_configuration(table, policy=policy,
                                                  configs=CONFIGS)
        assert full.expected_time_per_example <= (
            fixed.expected_time_per_example)


def test_autotuned_table_loads_in_the_reference_and_back(analytic_cifar):
    _, _, table = analytic_cifar
    ref = R_prof.ProfileTable.from_json(table.to_json())
    assert ref.to_json() == table.to_json()
    assert T_prof.ProfileTable.from_json(ref.to_json()) == table
    # the reference resolves the port's tile names as unknown variants,
    # so it maps the table over the fixed 8 only -- the port's result on
    # the same space
    want = R_map.map_efficient_configuration(ref, policy="dp",
                                             configs=CONFIGS)
    got = T_map.map_efficient_configuration(table, policy="dp",
                                            configs=CONFIGS)
    assert got.to_json() == want.to_json()


def test_analytic_rows_follow_the_h100_model(analytic_cifar):
    m, _, table = analytic_cifar
    for b in table.batch_sizes:
        for i, spec in enumerate(m.specs):
            for cfg in table.configs_for(b, i):
                k, h2d, d2h = T_cm.layer_time_split_h100(spec, cfg, b)
                assert table.kernel_time(b, i, cfg) == k / b
                assert table.times[b][i][cfg] == (k + h2d + d2h) / b
            assert table.h2d(b, i) == T_cm.layer_time_split_h100(
                spec, "XYZ", b)[1] / b


def test_analytic_profile_needs_no_device(analytic_cifar):
    m, packed, table = analytic_cifar
    fixed = T_prof.profile_bnn_model(m, packed, batch_sizes=(4,),
                                     time_source="analytic")
    for i in range(len(m.specs)):
        assert fixed.configs_for(4, i) == CONFIGS
        for cfg in CONFIGS:
            assert fixed.times[4][i][cfg] == table.times[4][i][cfg]
    with pytest.raises(ValueError, match="time_source"):
        T_prof.autotune_bnn_model(m, packed, batch_sizes=(1,),
                                  time_source="guessed")
