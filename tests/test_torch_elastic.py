"""The port's elastic subnets (``repro_torch.elastic``) against the JAX
package's ``repro.elastic``, on the same NumPy-made weights.

Equal, not within a tolerance: ``slice_packed`` against the
reference's and against a fresh ``pack_params`` of ``slice_params_fp``
(a Hypothesis property with ``deadline=None``), every narrowed tensor
contiguous after ``SubnetFamily.build`` (the paper nets' FC after an FC
included) and the bytes each level shares with the base or copies;
level names and store signatures; ``plan_family``'s per-level
configurations; the ``ElasticEngine``'s answers at every level, equal
to the reference's ``forward_packed`` and to its engine's; the
``QualityController`` journal over duck-typed engines and over real
elastic engines behind a ``FleetRouter``, under one fake clock.
Mirrors ``tests/test_elastic.py`` on CPU tensors."""

from __future__ import annotations

import dataclasses
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from fixtures import FakeClock, flat_table  # noqa: E402
from tests.test_elastic import _FakeElastic  # noqa: E402

from repro import api as R_API  # noqa: E402
from repro import elastic as R_EL  # noqa: E402
from repro import fleet as R_F  # noqa: E402
from repro import store as R_S  # noqa: E402
from repro.bnn import layers as R_L  # noqa: E402
from repro.bnn import models as R_M  # noqa: E402
from repro_torch import api as T_API  # noqa: E402
from repro_torch import elastic as T_EL  # noqa: E402
from repro_torch import fleet as T_F  # noqa: E402
from repro_torch import store as T_S  # noqa: E402
from repro_torch.bnn import layers as T_L  # noqa: E402
from repro_torch.bnn import models as T_M  # noqa: E402
from repro_torch.core.profiler import ProfileTable  # noqa: E402

# 8x8 input, both convs above the 32-lane clamp so every fraction
# genuinely narrows them, two pool stages so the FC-after-FLAT slice
# exercises the strided (per-spatial-position) path
SMALL_NOTATION = (
    "C64", "MP4", "S", "C64", "MP2", "S", "FLAT", "FC128", "S", "FC10",
)


def _models(name="elastic-small"):
    """(port model, reference model) of the small elastic net."""
    return (
        T_M.BNNModel(name, tuple(T_L.parse_notation(
            SMALL_NOTATION, (8, 8), 1, 10)), (8, 8), 1, 10),
        R_M.BNNModel(name, tuple(R_L.parse_notation(
            SMALL_NOTATION, (8, 8), 1, 10)), (8, 8), 1, 10),
    )


def _families(fractions=(1.0, 0.5), seed=0, name="elastic-small"):
    """Port and reference families built from the same fp weights."""
    m, r = _models(name)
    fp = T_M.random_fp_params(m.specs, seed)
    fam = T_EL.SubnetFamily.build(
        m, T_M.pack_params(m.specs, fp, device="cpu"),
        T_EL.ElasticSpec(fractions=fractions))
    r_fam = R_EL.SubnetFamily.build(
        r, R_M.pack_params(r.specs, fp),
        R_EL.ElasticSpec(fractions=fractions))
    return fam, r_fam, fp


def _assert_packed_equal(port, ref):
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert set(a) == set(b), f"layer {i}: keys"
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert np.array_equal(a[k].numpy(), np.asarray(b[k])), (
                    f"layer {i} [{k}]")
            else:
                assert a[k] == b[k], f"layer {i} [{k}]"


def _images(n, hw, seed):
    x01 = np.random.default_rng(seed).random((n, *hw, 1), dtype=np.float32)
    return (T_M.prepare_input_packed(torch.from_numpy(x01)),
            np.asarray(R_M.prepare_input_packed(jnp.asarray(x01))))


# ---------------------------------------------------------------------------
# subnet slicing
# ---------------------------------------------------------------------------


@settings(max_examples=6, deadline=None)
@given(
    fraction=st.sampled_from([0.75, 0.5, 0.25]),
    seed=st.integers(min_value=0, max_value=3),
)
def test_prefix_slice_bit_exact_vs_fresh_pack(fraction, seed):
    """Slicing the packed words equals packing the sliced fp weights,
    and the reference's slices — every tensor and the end-to-end
    packed forward, at any fraction and any weights."""
    fam, r_fam, fp = _families((1.0, fraction), seed)
    narrow = fam.level(1)
    fresh = T_M.pack_params(
        narrow.model.specs,
        T_EL.slice_params_fp(fam.base.model.specs, fp, narrow.model.specs),
        device="cpu")
    for i, (a, b) in enumerate(zip(narrow.packed, fresh)):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert a[k].is_contiguous(), f"layer {i} [{k}]"
                assert torch.equal(a[k], b[k]), f"layer {i} [{k}]"
            else:
                assert a[k] == b[k]
    _assert_packed_equal(narrow.packed, r_fam.level(1).packed)
    raw = T_EL.slice_packed(fam.base.model.specs, fam.base.packed,
                            narrow.model.specs)
    _assert_packed_equal(raw, r_fam.level(1).packed)
    xw, r_xw = _images(2, (8, 8), seed + 100)
    got = T_M.forward_packed(narrow.model.specs, narrow.packed, xw)
    assert torch.equal(got, T_M.forward_packed(narrow.model.specs, fresh, xw))
    assert np.array_equal(got.numpy(), np.asarray(R_M.forward_packed(
        r_fam.level(1).model.specs, r_fam.level(1).packed, r_xw)))


def test_narrow_levels_share_contiguous_prefixes_and_copy_strided_ones():
    fam, _, _ = _families((1.0, 0.5))
    base = fam.base.packed
    raw = T_EL.slice_packed(fam.base.model.specs, base,
                            fam.level(1).model.specs)
    # the FC after an FC narrowed on both axes is a row-strided view
    assert not raw[9]["w_words"].is_contiguous()
    built = fam.level(1).packed
    assert all(v.is_contiguous() for p in built for v in p.values()
               if isinstance(v, torch.Tensor))

    def shares(t, u):
        return t.untyped_storage().data_ptr() == u.untyped_storage().data_ptr()

    assert shares(built[0]["w_words"], base[0]["w_words"])   # Cin 1 word
    assert shares(built[2]["thresh"], base[2]["thresh"])     # step prefix
    assert not shares(built[3]["w_words"], base[3]["w_words"])  # both axes
    assert not shares(built[7]["w_words"], base[7]["w_words"])  # after FLAT
    assert not shares(built[9]["w_words"], base[9]["w_words"])  # after FC
    assert fam.storage(0) == {
        "shared_bytes": sum(v.numel() * v.element_size() for p in base
                            for v in p.values()
                            if isinstance(v, torch.Tensor)),
        "copied_bytes": 0,
    }
    s = fam.storage(1)
    assert s["copied_bytes"] == sum(
        built[i]["w_words"].numel() * 4 for i in (3, 7, 9))
    assert s["shared_bytes"] > 0


@pytest.mark.parametrize("arch", ["cifar10", "fashion_mnist"])
def test_paper_nets_narrow_fc_after_fc_is_contiguous(arch):
    """Both paper nets end FC S FC: the narrow level's last FC weight
    is a row-strided slice, contiguous after ``build`` and equal to the
    reference's and to a fresh pack."""
    m = T_M.build_model(arch, scale=0.25)
    r = R_M.build_model(arch, scale=0.25)
    fp = T_M.random_fp_params(m.specs, 3)
    spec = (1.0, 0.5)
    fam = T_EL.SubnetFamily.build(m, T_M.pack_params(m.specs, fp, device="cpu"),
                                  T_EL.ElasticSpec(fractions=spec))
    r_fam = R_EL.SubnetFamily.build(r, R_M.pack_params(r.specs, fp),
                                    R_EL.ElasticSpec(fractions=spec))
    last = len(m.specs) - 1
    assert m.specs[last].kind == "fc" and m.specs[last - 2].kind == "fc"
    raw = T_EL.slice_packed(m.specs, fam.base.packed, fam.level(1).model.specs)
    assert not raw[last]["w_words"].is_contiguous()
    w = fam.level(1).packed[last]["w_words"]
    assert w.is_contiguous()
    fresh = T_M.pack_params(fam.level(1).model.specs, T_EL.slice_params_fp(
        m.specs, fp, fam.level(1).model.specs), device="cpu")
    assert torch.equal(w, fresh[last]["w_words"])
    _assert_packed_equal(fam.level(1).packed, r_fam.level(1).packed)
    assert fam.names() == r_fam.names()


def test_family_levels_nest_and_level0_is_base():
    fam, r_fam, _ = _families((1.0, 0.5, 0.25))
    assert len(fam) == 3 and fam.names() == r_fam.names()
    assert fam.base.packed[0] is fam.level(0).packed[0]
    widths = [tuple(s.units for s in lvl.model.specs) for lvl in fam]
    assert widths == [tuple(s.units for s in lvl.model.specs)
                      for lvl in r_fam]
    for wide, narrow in zip(widths, widths[1:]):
        assert all(n <= w for w, n in zip(wide, narrow)) and narrow != wide
    for k in range(3):
        _assert_packed_equal(fam.level(k).packed, r_fam.level(k).packed)


def test_family_and_spec_validate_as_the_reference_does():
    for pkg in (T_EL, R_EL):
        for bad, match in (({"fractions": (0.5, 0.25)}, "start at 1.0"),
                           ({"fractions": (1.0, 0.5, 0.5)}, "decreasing"),
                           ({"fractions": (1.0, -0.5)}, r"\(0, 1\]"),
                           ({"fractions": (1.0, 0.5), "min_units": 48},
                            "min_units")):
            with pytest.raises(ValueError, match=match):
                pkg.ElasticSpec(**bad)
    with pytest.raises(ValueError, match="same widths"):
        _families((1.0, 0.25, 0.2))
    m, _ = _models()
    with pytest.raises(ValueError, match="do not match"):
        T_EL.SubnetFamily.build(m, [], T_EL.ElasticSpec())


def test_level_store_keys_never_collide_and_match_the_reference():
    fam, r_fam, _ = _families((1.0, 0.5, 0.25))
    assert fam.names() == ("elastic-small", "elastic-small#L1",
                           "elastic-small#L2")
    assert T_EL.level_name("m", 0) == "m" and T_EL.level_name("m", 2) == "m#L2"
    sigs = [T_S.model_signature(lvl.model) for lvl in fam]
    assert sigs == [R_S.model_signature(lvl.model) for lvl in r_fam]
    assert len(set(sigs)) == 3
    store = T_S.ProfileStore("mem://torch-elastic-keys", fingerprint="fp")
    assert len({store.profile_key(s, (4,)) for s in sigs}) == 3
    for lvl in fam:
        store.save_mapping(T_API.map_model(_table(lvl.model), policy="dp"))
    for lvl in fam:
        got = store.load_mapping(lvl.model, policy="dp", batch=4)
        assert got is not None and got.model_name == lvl.model.name


# ---------------------------------------------------------------------------
# per-level planning
# ---------------------------------------------------------------------------


def _table(model, batch=4):
    return ProfileTable.from_json(flat_table(model, batch=batch).to_json())


def _cfg(config):
    return json.loads(config.to_json())


def test_plan_family_warm_starts_every_level_equal_to_reference():
    fam, r_fam, _ = _families((1.0, 0.5))
    store = T_S.ProfileStore("mem://torch-elastic-warm", fingerprint="fp")
    r_store = R_S.ProfileStore("mem://torch-elastic-warm", fingerprint="fp")
    for lvl, r_lvl in zip(fam, r_fam):
        store.save_profile(_table(lvl.model))
        r_store.save_profile(flat_table(r_lvl.model, batch=4))
    plan = T_EL.plan_family(fam, batch_sizes=(4,), store=store,
                            device="cpu")
    want = R_EL.plan_family(r_fam, batch_sizes=(4,), store=r_store)
    assert store.stats()["hits"] >= 2
    assert plan.predicted == want.predicted == (False, False)
    assert [_cfg(c) for c in plan.configs] == [_cfg(c) for c in want.configs]
    assert plan.batch == 4 and [tp.name for tp in plan.levels] == list(
        fam.names())
    for lvl in fam:
        assert store.load_mapping(lvl.model, policy="dp", batch=4)


def test_plan_family_rejects_base_plan_for_other_model():
    fam, _, _ = _families()
    other, _ = _models("not-in-family")
    t = _table(other)
    base = T_API.TenantPlan(name=other.name, model=other, packed=[],
                            table=t, config=T_API.map_model(t))
    with pytest.raises(ValueError, match="different model"):
        T_EL.plan_family(fam, base=base, device="cpu")


def test_plan_family_estimate_prices_narrow_levels_via_predictor():
    fam, _, _ = _families((1.0, 0.5))
    store = T_S.ProfileStore("mem://torch-elastic-est", fingerprint="fp")
    store.save_profile(_table(fam.base.model))
    predicted = []

    class _FakePredictor:
        def predict_table(self, model, batch_sizes, *, registry=None,
                          configs=None):
            predicted.append(model.name)
            return _table(model, batch=batch_sizes[0])

    store.load_predictor = lambda: _FakePredictor()
    plan = T_EL.plan_family(fam, batch_sizes=(4,), store=store,
                            estimate=True, device="cpu")
    assert plan.predicted == (False, True)
    assert predicted == [fam.level(1).model.name]
    assert store.load_mapping(fam.level(1).model, policy="dp", batch=4)
    assert store.load_profile(fam.level(1).model, (4,)) is None
    fallback = T_S.ProfileStore("mem://torch-elastic-fb", fingerprint="fp")
    for lvl in fam:
        fallback.save_profile(_table(lvl.model))
    assert T_EL.plan_family(fam, batch_sizes=(4,), store=fallback,
                            estimate=True, device="cpu").predicted == (
                                False, False)


# ---------------------------------------------------------------------------
# ElasticEngine: level switches at batch boundaries
# ---------------------------------------------------------------------------


def _plans(batch=2, fractions=(1.0, 0.5)):
    """Port and reference ElasticPlans over flat tables."""
    fam, r_fam, _ = _families(fractions)
    levels, r_levels = [], []
    for lvl, r_lvl in zip(fam, r_fam):
        t = _table(lvl.model, batch)
        levels.append(T_API.TenantPlan(
            name=lvl.model.name, model=lvl.model, packed=lvl.packed,
            table=t, config=T_API.map_model(t)))
        rt = flat_table(r_lvl.model, batch=batch)
        r_levels.append(R_API.TenantPlan(
            name=r_lvl.model.name, model=r_lvl.model, packed=r_lvl.packed,
            table=rt, config=R_API.map_model(rt)))
    pred = (False,) * len(fam)
    return (T_EL.ElasticPlan(family=fam, levels=tuple(levels), predicted=pred),
            R_EL.ElasticPlan(family=r_fam, levels=tuple(r_levels),
                             predicted=pred))


def _engine(plan, batch=2, **kw):
    return T_EL.ElasticEngine(plan, allowed_batch_sizes=(batch,),
                              max_wait_s=0.0, device="cpu",
                              clock=FakeClock(), **kw)


def _refs(r_plan, r_xw):
    return [np.asarray(R_M.forward_packed(tp.model.specs, tp.packed, r_xw))
            for tp in r_plan.levels]


def test_engine_level_switches_serve_bit_exact_with_the_reference():
    plan, r_plan = _plans()
    engine = _engine(plan)
    r_engine = R_EL.ElasticEngine(r_plan, allowed_batch_sizes=(2,),
                                  max_wait_s=0.0, clock=FakeClock())
    engine.warm()
    assert set(engine._pipelines) == {0, 1}
    xw, r_xw = _images(2, (8, 8), 5)
    refs = _refs(r_plan, r_xw)
    for k in (0, 1, 0):
        for e in (engine, r_engine):
            assert e.set_level(k) is True and e.level == k
        assert engine.model.name == plan.levels[k].name
        reqs = [engine.submit(x.numpy()) for x in xw]
        r_reqs = [r_engine.submit(x) for x in r_xw]
        engine.step(force=True)
        r_engine.step(force=True)
        for j, (r, rr) in enumerate(zip(reqs, r_reqs)):
            got = r.wait(timeout=30)
            assert np.array_equal(got, refs[k][j]), f"level {k} [{j}]"
            assert np.array_equal(got, np.asarray(rr.wait(timeout=30)))
    assert engine.level_switches == r_engine.level_switches == 2
    assert engine.degraded_share == r_engine.degraded_share
    assert 0.0 < engine.degraded_share < 1.0


def test_engine_validates_floor_and_levels_as_the_reference_does():
    plan, _ = _plans()
    single = T_EL.ElasticPlan(family=plan.family, levels=plan.levels[:1],
                              predicted=(False,))
    with pytest.raises(ValueError, match="two subnet levels"):
        _engine(single)
    engine = _engine(plan, quality_floor=0)
    assert engine.quality_floor == 0 and not engine.can_degrade()
    with pytest.raises(ValueError, match="quality_floor"):
        engine.set_level(1)
    with pytest.raises(ValueError, match="outside"):
        engine.set_level(5)
    with pytest.raises(ValueError, match="quality_floor"):
        _engine(plan, quality_floor=7)


def test_engine_defers_level_switch_mid_step():
    plan, _ = _plans()
    engine = _engine(plan)
    engine._in_step = True                     # simulate in-flight wave
    assert engine.set_level(1) is False
    assert engine.level == 0 and engine._pending_level == 1
    engine._in_step = False
    engine.step(force=True)                    # empty queue: boundary
    assert engine.level == 1 and engine._pending_level is None


def test_engine_routes_swap_by_model_name():
    plan, _ = _plans()
    engine = _engine(plan)
    new_l1 = T_API.map_model(_table(plan.levels[1].model, 2),
                             policy="greedy")
    assert engine.swap_configuration(new_l1) is True
    assert engine.level_config(1) is new_l1
    assert engine.config is engine.level_config(0)
    stranger, _ = _models("stranger")
    with pytest.raises(ValueError, match="no subnet level"):
        engine.swap_configuration(T_API.map_model(_table(stranger, 2)))
    with pytest.raises(ValueError, match="batch size"):
        engine.swap_configuration(
            T_API.map_model(_table(plan.levels[1].model, 4)))


# ---------------------------------------------------------------------------
# QualityController: the same hysteresis as the reference's
# ---------------------------------------------------------------------------


# (engine kwargs, start level, tenant deadline, controller knobs,
#  [(shed this tick, deadline from now on or None)])
SCENARIOS = {
    "degrade_hysteresis": ({}, 0, math.inf,
                           {"degrade_after": 3, "restore_after": 2},
                           [(2, None), (1, None), (4, None), (1, None)]),
    "floor_hold": ({"floor": 1}, 1, math.inf,
                   {"degrade_after": 1, "restore_after": 9}, [(5, None)]),
    "restore_gated_by_headroom": ({"step_s": 1.0, "batch": 4}, 1, 7.0,
                                  {"degrade_after": 1, "restore_after": 2,
                                   "headroom": 0.5},
                                  [(0, None)] * 4 + [(0, math.inf)]),
    "shed_resets_restore": ({}, 1, math.inf,
                            {"degrade_after": 9, "restore_after": 3},
                            [(0, None), (0, None), (1, None), (0, None),
                             (0, None), (0, None)]),
}


def _run_quality(pkg, name):
    eng_kw, start, deadline, knobs, ticks = SCENARIOS[name]
    engine = _FakeElastic(**eng_kw)
    engine.level = start
    tenant = pkg.Tenant(name="t", engine=engine, deadline_s=deadline)
    router = SimpleNamespace(tenants=lambda: (tenant,))
    clock = FakeClock()
    qc = pkg.QualityController(clock=clock, **knobs)
    out = []
    for shed, new_deadline in ticks:
        if new_deadline is not None:
            tenant.deadline_s = new_deadline
        tenant.rejected += shed
        out.append([dataclasses.asdict(r) for r in qc.observe(router)])
        clock.advance(0.5)
    return out, engine.level, engine.level_switches


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_quality_controller_journal_equal_to_reference(scenario):
    got = _run_quality(T_F, scenario)
    assert got == _run_quality(R_F, scenario)
    ticks, level, _ = got
    actions = [r["action"] for tick in ticks for r in tick]
    assert actions == {
        "degrade_hysteresis": ["degrade"],
        "floor_hold": ["floor_hold"],
        "restore_gated_by_headroom": ["restore"],
        "shed_resets_restore": ["restore"],
    }[scenario]
    assert level == {"degrade_hysteresis": 1, "floor_hold": 1,
                     "restore_gated_by_headroom": 0,
                     "shed_resets_restore": 0}[scenario]


def test_quality_ignores_non_elastic_tenants_and_validates_knobs():
    engine = SimpleNamespace(config=None, telemetry=None)
    tenant = T_F.Tenant(name="t", engine=engine)
    qc = T_F.QualityController(degrade_after=1, clock=FakeClock())
    tenant.rejected = 50
    assert qc.observe(SimpleNamespace(tenants=lambda: (tenant,))) == []
    for bad in ({"degrade_after": 0}, {"restore_after": 0},
                {"headroom": 0.0}, {"headroom": 1.5}):
        with pytest.raises(ValueError):
            T_F.QualityController(**bad)


def test_router_degrades_an_elastic_tenant_bit_exact_with_the_reference():
    """Real elastic engines behind a router with a quality controller in
    both packages: bursts past the deadline shed, two shed rounds
    degrade to level 1, the floor then holds; each round's answers
    equal the reference forward of the level read before the round,
    and journals and stats are equal."""
    plan, r_plan = _plans(batch=2)
    step_s = plan.configs[0].expected_time_per_example * 2
    rigs = []
    for pkg, p, make in (
        (T_F, plan, lambda p: _engine(p)),
        (R_F, r_plan, lambda p: R_EL.ElasticEngine(
            p, allowed_batch_sizes=(2,), max_wait_s=0.0, clock=FakeClock())),
    ):
        clock = FakeClock()
        qc = pkg.QualityController(degrade_after=2, clock=clock)
        router = pkg.FleetRouter(ledger=pkg.DeviceTimeLedger(), quality=qc)
        engine = make(p)
        router.add_tenant("e", engine, deadline_s=1.5 * step_s)
        rigs.append((router, engine, qc, clock))
    xw, r_xw = _images(6, (8, 8), 9)
    refs = _refs(r_plan, r_xw)
    levels = []
    for _ in range(4):
        rounds = []
        for (router, engine, _, clock), xs in zip(rigs, (
                [x.numpy() for x in xw], list(r_xw))):
            level = engine.level              # the level serving this round
            reqs = [router.submit("e", x) for x in xs]
            router.step(force=True)
            clock.advance(0.01)
            rounds.append((level, [None if r is None else
                                   np.asarray(r.wait(timeout=30))
                                   for r in reqs]))
        (lvl, got), (r_lvl, want) = rounds
        assert lvl == r_lvl
        levels.append(lvl)
        for j, (a, b) in enumerate(zip(got, want)):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a, refs[lvl][j])
                assert np.array_equal(a, b)
    assert levels == [0, 0, 1, 1]
    journals = [[dataclasses.asdict(r) for r in qc.journal]
                for _, _, qc, _ in rigs]
    assert journals[0] == journals[1]
    assert [r["action"] for r in journals[0]] == ["degrade", "floor_hold"]
    assert rigs[0][0].stats() == rigs[1][0].stats()
