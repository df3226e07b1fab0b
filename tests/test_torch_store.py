"""The port's profile store (``repro_torch.store``) against the JAX
package's: the same key algebra (model signatures, registry hashes,
batch keys, fleet scopes), the same envelopes and layout (a root one
package writes, the other reads), warm starts with zero profiling, and
gc/export, and the estimator's artifacts (training rows equal apart
from the fixed 8's tile fields, predictors and interference laws read
across packages).  The hardware fingerprints differ by design, so the
two packages' entries never collide.  Mirrors the cases of
``tests/test_profile_store.py`` and ``tests/test_estimator.py`` that
need no reference CLI."""

from __future__ import annotations

import importlib
import json
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import fixtures  # noqa: E402

from repro import estimator as R_E  # noqa: E402
from repro import store as R_S  # noqa: E402
from repro.bnn import models as R_M  # noqa: E402
from repro.core import mapper as R_MAP  # noqa: E402
from repro.core.parallel_config import CONFIGS, CPU  # noqa: E402
from repro.core.profiler import ProfileTable as R_Table  # noqa: E402
from repro.kernels import registry as R_REG  # noqa: E402
from repro_torch import estimator as T_E  # noqa: E402
from repro_torch.bnn import models as T_M  # noqa: E402
from repro_torch.core import mapper as T_MAP  # noqa: E402
from repro_torch.core.mapper import EfficientConfiguration  # noqa: E402
from repro_torch.core.profiler import ProfileTable  # noqa: E402
from repro_torch.kernels import registry as T_REG  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.store import (  # noqa: E402
    ProfileStore,
    fleet_scope,
    hardware_fingerprint,
    model_signature,
    registry_hash,
    signature_from_labels,
)

MODEL = T_M.build_model("fashion_mnist", scale=0.25)
R_MODEL = R_M.build_model("fashion_mnist", scale=0.25)
LABELS = tuple(f"L{s.idx}:{s.notation}" for s in MODEL.specs)


def _table_args(model_name="m", batches=(1, 4), labels=None, seed=0):
    """(args, kwargs) of a random split table, for either package's
    ``ProfileTable``."""
    labels = labels or tuple(f"L{i+1}:C8" for i in range(3))
    rng = np.random.default_rng(seed)
    times, kernels, h2d, d2h = {}, {}, {}, {}
    for b in batches:
        times[b], kernels[b], h2d[b], d2h[b] = [], [], [], []
        for _ in labels:
            krow = {c: float(rng.uniform(1e-6, 1e-3)) for c in CONFIGS}
            up, down = (float(x) for x in rng.uniform(1e-6, 5e-4, 2))
            kernels[b].append(krow)
            times[b].append({c: krow[c] if c == CPU else krow[c] + up + down
                             for c in CONFIGS})
            h2d[b].append(up)
            d2h[b].append(down)
    return (model_name, tuple(batches), labels, times), dict(
        kernel_times=kernels, h2d_times=h2d, d2h_times=d2h)


def _table(model_name="m", batches=(1, 4), labels=None, seed=0):
    args, kw = _table_args(model_name, batches, labels, seed)
    return ProfileTable(*args, **kw)


def _model_table(batches=(1, 4)):
    return _table(MODEL.name, batches, LABELS)


def _same_rows_registry():
    """A JAX-package registry holding exactly the port's default rows
    (name, scope, placement, aspects, p_blk, n_blk, analytic)."""
    reg = R_REG.VariantRegistry()
    for v in T_REG.DEFAULT_REGISTRY:
        reg.register(R_REG.KernelVariant(
            name=v.name, builder=v.builder, placement=v.placement,
            scope=v.scope, aspects=tuple(v.aspects), p_blk=v.p_blk,
            n_blk=v.n_blk, analytic=v.analytic))
    return reg


@pytest.mark.parametrize("name", ["adapt", "store", "cachesvc"])
def test_public_names_match_the_reference(name):
    """Every public name of the JAX package's subpackage is exported by
    the port's."""
    ref = importlib.import_module(f"repro.{name}")
    port = importlib.import_module(f"repro_torch.{name}")
    want = getattr(ref, "__all__", None) or [
        n for n, v in vars(ref).items()
        if not n.startswith("_") and not isinstance(v, types.ModuleType)
        and n != "annotations"]
    assert set(want) <= set(port.__all__)
    for n in want:
        assert getattr(port, n) is not None


# ---------------------------------------------------------------------------
# ProfileTable JSON
# ---------------------------------------------------------------------------


def test_profile_table_json_roundtrip_exact_and_equal_to_reference():
    args, kw = _table_args()
    t = ProfileTable(*args, **kw)
    t2 = ProfileTable.from_json(t.to_json())
    assert (t2.model_name, t2.batch_sizes, t2.layer_labels) == (
        t.model_name, t.batch_sizes, t.layer_labels)
    assert t2.times == t.times and t2.kernel_times == t.kernel_times
    assert t2.h2d_times == t.h2d_times and t2.d2h_times == t.d2h_times
    doc = json.loads(t.to_json())
    assert doc["schema"] == ProfileTable.SCHEMA_VERSION
    assert doc["kind"] == "profile_table"
    assert doc == json.loads(R_Table(*args, **kw).to_json())


def test_profile_table_json_legacy_tolerant():
    legacy = {"model": "m", "batch_sizes": [1], "layer_labels": ["L1:C8"],
              "times": {"1": [{"CPU": 1.0, "X": 2.0}]}}
    t = ProfileTable.from_json(json.dumps(legacy))
    assert t.batch_sizes == (1,)
    assert t.kernel_time(1, 0, "X") == 2.0
    assert t.h2d(1, 0) == 0.0 and t.d2h(1, 0) == 0.0
    assert t.boundary_time(1, 0, "X") == 0.0
    t2 = ProfileTable.from_json(t.to_json())
    assert t2.times == t.times and t2.kernel_times is None


def test_profile_table_json_refuses_newer_schema_and_wrong_kind():
    doc = json.loads(_table().to_json())
    doc["schema"] = ProfileTable.SCHEMA_VERSION + 1
    with pytest.raises(ValueError, match="newer"):
        ProfileTable.from_json(json.dumps(doc))
    doc["schema"] = ProfileTable.SCHEMA_VERSION
    doc["kind"] = "efficient_configuration"
    with pytest.raises(ValueError, match="profile_table"):
        ProfileTable.from_json(json.dumps(doc))


# ---------------------------------------------------------------------------
# keys: equal algebra, different fingerprints
# ---------------------------------------------------------------------------


def test_fingerprint_and_signatures_are_stable_and_equal_to_reference():
    assert hardware_fingerprint("cpu") == hardware_fingerprint("cpu")
    assert model_signature(MODEL) == model_signature(MODEL)
    assert model_signature(MODEL) == R_S.model_signature(R_MODEL)
    t = _table(model_name=MODEL.name)
    assert signature_from_labels(MODEL.name, t.layer_labels) != (
        model_signature(MODEL))
    assert signature_from_labels(MODEL.name, LABELS) == model_signature(MODEL)
    for name, labels in ((MODEL.name, LABELS), ("m", ("L1:C8", "L2:S"))):
        assert signature_from_labels(name, labels) == (
            R_S.signature_from_labels(name, labels))


def test_fingerprints_keep_port_and_reference_entries_apart(tmp_path):
    """The port hashes the torch device, the JAX package its backend:
    the same root, model and registry rows never cross-read."""
    assert hardware_fingerprint("cpu") != R_S.hardware_fingerprint()
    if torch.cuda.is_available():
        assert hardware_fingerprint() == hardware_fingerprint("cuda")
        assert hardware_fingerprint("cuda") != hardware_fingerprint("cpu")
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            hardware_fingerprint()
    t = _model_table()
    ref = R_S.ProfileStore(tmp_path, registry=_same_rows_registry())
    port = ProfileStore(tmp_path, device="cpu")
    assert ref.space_hash == port.space_hash
    ref.save_profile(R_Table.from_json(t.to_json()))
    assert port.load_profile(MODEL, t.batch_sizes) is None
    port.save_profile(t)
    assert port.load_profile(MODEL, t.batch_sizes) is not None
    assert len(ref.entries()) == 2 and ref.fingerprint != port.fingerprint


def test_registry_hash_tracks_the_variant_space():
    base = registry_hash()
    custom = T_REG._register_defaults(T_REG.VariantRegistry())
    assert registry_hash(custom) == base
    custom.register(T_REG.KernelVariant(
        name="my_kernel", builder=lambda a, w, k: a, placement="device"))
    assert registry_hash(custom) != base


def test_registry_hash_equal_for_equal_rows():
    """The same variant rows hash the same in both packages — including
    the pricing fields p_blk, n_blk and analytic, which re-key."""
    ref = _same_rows_registry()
    assert registry_hash() == R_S.registry_hash(ref)
    tags = {v.name: v.analytic for v in T_REG.DEFAULT_REGISTRY}
    assert tags["CPU"] == "host" and tags["seg_cuda"] == "fused"
    assert {tags[a] for a in ("X", "Y", "Z", "XY", "XZ", "YZ", "XYZ")} == {
        "tiled"}
    assert all(v.p_blk is None and v.n_blk is None
               for v in T_REG.DEFAULT_REGISTRY if v.name in tags
               and not v.name.startswith("cuda_p"))
    for field, value in (("p_blk", 64), ("n_blk", 16), ("analytic", "fused")):
        port = T_REG._register_defaults(T_REG.VariantRegistry())
        reg = _same_rows_registry()
        for r in (port, reg):
            v = r.remove("X")
            kw = dict(name=v.name, builder=v.builder, placement=v.placement,
                      scope=v.scope, aspects=v.aspects, p_blk=v.p_blk,
                      n_blk=v.n_blk, analytic=v.analytic)
            kw[field] = value
            r.register(type(v)(**kw))
        assert registry_hash(port) == R_S.registry_hash(reg) != registry_hash()


# ---------------------------------------------------------------------------
# store round trips and isolation
# ---------------------------------------------------------------------------


def test_store_profile_roundtrip_and_cross_fingerprint_isolation(tmp_path):
    t = _model_table()
    a = ProfileStore(tmp_path, fingerprint="machine-a")
    assert a.save_profile(t).exists()
    got = a.load_profile(MODEL, t.batch_sizes)
    assert got is not None and got.times == t.times
    b = ProfileStore(tmp_path, fingerprint="machine-b")
    assert b.load_profile(MODEL, t.batch_sizes) is None
    assert a.load_profile(MODEL, (1, 2)) is None


def test_store_batch_key_is_order_insensitive(tmp_path):
    t = _model_table()
    store = ProfileStore(tmp_path, fingerprint="machine-a")
    store.save_profile(t)
    got = store.load_profile(MODEL, (4, 1))
    assert got is not None and got.times == t.times


def test_identical_signatures_different_registries_never_collide(tmp_path):
    t = _model_table()
    reg2 = T_REG._register_defaults(T_REG.VariantRegistry())
    reg2.register(T_REG.KernelVariant(
        name="fleet_only", placement="device", aspects=("X",),
        builder=lambda p, w, k: None))
    a = ProfileStore(tmp_path, fingerprint="f")
    b = ProfileStore(tmp_path, fingerprint="f", registry=reg2)
    assert a.space_hash != b.space_hash
    a.save_profile(t)
    assert a.load_profile(MODEL, t.batch_sizes) is not None
    assert b.load_profile(MODEL, t.batch_sizes) is None
    b.save_profile(t)
    sig = model_signature(MODEL)
    assert a.profile_path(sig, t.batch_sizes) != b.profile_path(
        sig, t.batch_sizes)
    assert b.load_profile(MODEL, t.batch_sizes) is not None


def test_fleet_scope_round_trip_and_isolation(tmp_path):
    t = _model_table()
    ec = T_MAP.map_efficient_configuration(t, policy="dp")
    scope = fleet_scope(("mnist-a", "mnist-b"))
    assert scope == fleet_scope(("mnist-b", "mnist-a", "mnist-a"))
    assert scope != fleet_scope(("mnist-a", "mnist-c"))
    assert scope == R_S.fleet_scope(("mnist-a", "mnist-b"))
    with pytest.raises(ValueError):
        fleet_scope(())
    solo = ProfileStore(tmp_path, fingerprint="f")
    fleet = ProfileStore(tmp_path, fingerprint="f", scope=scope)
    other = ProfileStore(tmp_path, fingerprint="f",
                         scope=fleet_scope(("x", "y")))
    fleet.save_mapping(ec)
    fleet.save_profile(t)
    got = fleet.load_mapping(MODEL, policy="dp")
    assert got is not None and got.layer_configs == ec.layer_configs
    assert fleet.load_profile(MODEL, t.batch_sizes) is not None
    assert solo.load_mapping(MODEL, policy="dp") is None
    assert other.load_mapping(MODEL, policy="dp") is None
    solo.save_mapping(ec)
    assert solo.load_mapping(MODEL, policy="dp") is not None
    assert other.load_mapping(MODEL, policy="dp") is None
    doc = json.loads(fleet.mapping_path(
        model_signature(MODEL), "dp", ec.proper_batch_size).read_text())
    assert doc["key"]["scope"] == scope
    kinds = [e.key.get("scope") for e in solo.entries()]
    assert scope in kinds and None in kinds
    assert fleet.with_scope(None).load_mapping(MODEL) is not None


def test_store_scope_validates(tmp_path):
    for bad in ("", "a/b"):
        with pytest.raises(ValueError, match="scope"):
            ProfileStore(tmp_path, scope=bad)


def test_warm_start_rejects_mapping_from_unprofiled_batch(tmp_path):
    t = _model_table((1, 4))
    t16 = _table(MODEL.name, (16,), LABELS)
    store = ProfileStore(tmp_path, fingerprint="machine-a")
    store.save_profile(t)
    store.save_mapping(T_MAP.map_efficient_configuration(t, policy="dp"))
    store.save_mapping(T_MAP.map_efficient_configuration(t16, policy="dp"))
    table, config = store.warm_start(MODEL, batch_sizes=(1, 4))
    assert config.proper_batch_size in table.batch_sizes


def test_store_mapping_roundtrip(tmp_path):
    t = _model_table()
    ec = T_MAP.map_efficient_configuration(t, policy="dp")
    store = ProfileStore(tmp_path, fingerprint="machine-a")
    store.save_mapping(ec)
    got = store.load_mapping(MODEL, policy="dp")
    assert isinstance(got, EfficientConfiguration)
    assert got.layer_configs == ec.layer_configs
    assert got.proper_batch_size == ec.proper_batch_size
    assert store.load_mapping(MODEL, policy="greedy") is None
    assert store.load_mapping(
        MODEL, policy="dp", batch=ec.proper_batch_size) is not None
    assert store.load_mapping_for_labels(
        signature_from_labels(MODEL.name, LABELS), policy="dp") is not None


def test_warm_start_serves_with_zero_profiler_invocations(tmp_path):
    """Save, reload under the same fingerprint, serve — counting
    profiler invocations; the served answers equal the JAX package's
    forward_packed."""
    fp = T_M.random_fp_params(MODEL.specs, 0)
    packed = T_M.pack_params(MODEL.specs, fp, device="cpu")
    calls = []

    def fake_profiler(model, packed_params, *, batch_sizes):
        calls.append(batch_sizes)
        return _table(model.name, batch_sizes, LABELS)

    store = ProfileStore(tmp_path, device="cpu")
    assert store.warm_start(MODEL, batch_sizes=(1, 4)) is None
    t1, loaded = store.get_or_profile(MODEL, packed, fake_profiler,
                                      batch_sizes=(1, 4))
    assert not loaded and len(calls) == 1
    store2 = ProfileStore(tmp_path, device="cpu")
    t2, loaded = store2.get_or_profile(MODEL, packed, fake_profiler,
                                       batch_sizes=(1, 4))
    assert loaded and len(calls) == 1 and t2.times == t1.times
    warm = store2.warm_start(MODEL, batch_sizes=(1, 4))
    assert warm is not None and len(calls) == 1
    table, config = warm
    engine = ServingEngine(MODEL, packed, config,
                           allowed_batch_sizes=table.batch_sizes, device="cpu")
    x01 = np.random.default_rng(7).random((4, 28, 28, 1), dtype=np.float32)
    xw = np.asarray(R_M.prepare_input_packed(jnp.asarray(x01)))
    reqs = [engine.submit(xw[i]) for i in range(4)]
    assert engine.step(force=True) == 4
    ref = np.asarray(R_M.forward_packed(
        R_MODEL.specs, R_M.pack_params(R_MODEL.specs, fp), xw))
    for i, r in enumerate(reqs):
        assert np.array_equal(r.wait(timeout=30), ref[i])
    assert store2.load_mapping(MODEL, policy="dp") is not None
    assert len(calls) == 1


def test_store_root_reads_across_packages(tmp_path):
    """Same fingerprint and registry rows: a profile and a mapping saved
    by one package load in the other, at the same keys, with equal
    payloads — in both directions."""
    t = _model_table()
    r_t = R_Table.from_json(t.to_json())
    for writer in ("reference", "port"):
        root = tmp_path / writer
        ref = R_S.ProfileStore(root, fingerprint="fp",
                               registry=_same_rows_registry())
        port = ProfileStore(root, fingerprint="fp")
        if writer == "reference":
            ref.save_profile(r_t)
            ref.save_mapping(R_MAP.map_efficient_configuration(r_t, policy="dp"))
        else:
            port.save_profile(t)
            port.save_mapping(T_MAP.map_efficient_configuration(t, policy="dp"))
        sig = model_signature(MODEL)
        assert port.profile_key(sig, (1, 4)) == ref.profile_key(sig, (1, 4))
        assert port.mapping_key(sig, "dp", 4) == ref.mapping_key(sig, "dp", 4)
        got_t = port.load_profile(MODEL, (1, 4))
        got_r = ref.load_profile(R_MODEL, (1, 4))
        assert json.loads(got_t.to_json()) == json.loads(got_r.to_json())
        ec = port.load_mapping(MODEL)
        r_ec = ref.load_mapping(R_MODEL)
        assert json.loads(ec.to_json()) == json.loads(r_ec.to_json())
        assert sorted(e.store_key for e in port.entries()) == sorted(
            e.store_key for e in ref.entries())


def _without_tiles(rows):
    """Training rows without the fixed 8's tile fields, which differ by
    design (64 in the port, 128 in the JAX package)."""
    return [{**r, "meta": {k: v for k, v in r["meta"].items()
                           if k not in ("p_blk", "n_blk")}} for r in rows]


def _fake_profiler(model, packed, *, batch_sizes):
    return ProfileTable.from_json(
        fixtures.loglinear_table(model, batch_sizes).to_json())


def _ref_fake_profiler(model, packed, *, batch_sizes):
    return fixtures.loglinear_table(model, batch_sizes)


def test_get_or_profile_records_training_rows_like_the_reference(tmp_path):
    """Both packages record one training-row document per profiled
    sweep, under the same layout; the rows are equal apart from the
    stated tile fields, and a warm start records none."""
    m = fixtures.synthetic_model("fed", conv_units=(24, 48),
                                 fc_units=(64, 10))
    port = ProfileStore(tmp_path / "port", fingerprint="fp")
    ref = R_S.ProfileStore(tmp_path / "ref", fingerprint="fp",
                           registry=_same_rows_registry())
    port.get_or_profile(m, None, _fake_profiler, batch_sizes=(1, 4))
    ref.get_or_profile(m, None, _ref_fake_profiler, batch_sizes=(1, 4))
    rows = port.load_training_rows()
    assert len(rows) == 2 * len(m.specs) * len(CONFIGS)
    assert _without_tiles(rows) == _without_tiles(ref.load_training_rows())
    assert {r["meta"]["p_blk"] for r in rows} == {64}
    assert sorted(k for k in port.backend.list() if "training-" in k) == (
        sorted(k for k in ref.backend.list() if "training-" in k))
    _, loaded = port.get_or_profile(m, None, _fake_profiler,
                                    batch_sizes=(1, 4))
    assert loaded and len(port.load_training_rows()) == len(rows)


def test_training_rows_predictor_and_law_round_trip(tmp_path):
    store = ProfileStore(tmp_path, fingerprint="fp")
    assert store.load_training_rows() == [] and store.predictor() is None
    assert store.predictor_meta() is None and store.load_predictor() is None
    assert store.load_interference() is None
    m = fixtures.synthetic_model("s")
    table = ProfileTable.from_json(fixtures.loglinear_table(m).to_json())
    rows = T_E.training_rows_from_table(m, table)
    store.save_training_rows(rows)
    assert store.load_training_rows() == rows
    m2 = fixtures.synthetic_model("s2", conv_units=(16,))
    rows2 = T_E.training_rows_from_table(m2, ProfileTable.from_json(
        fixtures.loglinear_table(m2).to_json()))
    store.save_training_rows(rows2)
    store.save_training_rows(rows)            # same source: overwrites
    assert len(store.load_training_rows()) == len(rows) + len(rows2)
    with pytest.raises(ValueError):
        store.save_training_rows([])
    assert ProfileStore(tmp_path, fingerprint="other").load_training_rows() \
        == []
    pred = store.predictor()
    assert pred.to_json() == R_E.LatencyPredictor().fit(
        store.load_training_rows()).to_json()
    store.save_predictor(pred, source_rows=len(rows) + len(rows2))
    meta = store.predictor_meta()
    assert (meta["n_rows"], meta["source_rows"]) == (pred.n_rows,
                                                     len(rows) + len(rows2))
    assert store.load_predictor().to_json() == pred.to_json()
    law = T_E.FittedInterference(gamma=0.4, knots=((0.5, 1.1), (1.0, 1.5)),
                                 n_obs=9)
    store.save_interference(law)
    assert store.load_interference() == law


def test_estimator_artifacts_read_across_packages(tmp_path):
    """Same fingerprint and registry rows: a predictor and a law saved by
    one package load in the other."""
    port = ProfileStore(tmp_path, fingerprint="fp")
    ref = R_S.ProfileStore(tmp_path, fingerprint="fp",
                           registry=_same_rows_registry())
    m = fixtures.synthetic_model("x")
    rows = R_E.training_rows_from_table(m, fixtures.loglinear_table(m))
    ref.save_training_rows(rows)
    assert port.load_training_rows() == rows
    pred = port.predictor()
    port.save_predictor(pred, source_rows=len(rows))
    assert ref.load_predictor().to_json() == pred.to_json()
    assert ref.predictor_meta()["n_rows"] == port.predictor_meta()["n_rows"]
    law = R_E.FittedInterference(gamma=0.9)
    ref.save_interference(law)
    assert port.load_interference().to_json() == law.to_json()


# ---------------------------------------------------------------------------
# maintenance: entries / gc / export
# ---------------------------------------------------------------------------


def _seeded_store(root):
    t = _model_table()
    store = ProfileStore(root, fingerprint="machine-a")
    store.save_profile(t)
    store.save_mapping(T_MAP.map_efficient_configuration(t, policy="dp"))
    return store


def test_entries_gc_and_export(tmp_path):
    store = _seeded_store(tmp_path)
    assert {e.kind for e in store.entries()} == {
        "profile_table", "efficient_configuration"}
    old = tmp_path / "v0" / "machine-a" / "x" / "profile-b1.json"
    old.parent.mkdir(parents=True)
    old.write_text(json.dumps({
        "schema": 0, "kind": "profile_table",
        "saved_at": time.time() - 1e6, "key": {}, "payload": {}}))
    assert len(store.entries()) == 3
    assert store.gc(dry_run=True) == [old] and old.exists()
    assert store.gc() == [old] and not old.exists()
    assert not (tmp_path / "v0").exists()
    assert len(store.gc(max_age_s=0.0)) == 2
    assert store.entries() == []
    bundle = _seeded_store(tmp_path).export()
    assert bundle["kind"] == "profile_store_export"
    assert len(bundle["entries"]) == 2
    for e in bundle["entries"]:
        assert "payload" in e["document"]
    stats = store.stats()
    assert stats["backend"] == "dir" and stats["entries"] == 2


def test_plan_single_reads_through_backend_uri(tmp_path):
    from repro_torch import api

    packed = T_M.pack_params(MODEL.specs, T_M.random_fp_params(MODEL.specs, 0),
                             device="cpu")
    store = ProfileStore(f"sqlite://{tmp_path}/api.db", device="cpu")
    tp1 = api.plan_single(MODEL, packed, batch_sizes=(4,), store=store,
                          time_source="analytic", repeats=1, device="cpu")
    before = store.stats()["hits"]
    # the facade takes the URI itself and keys it by the same device
    tp2 = api.plan_single(MODEL, packed, batch_sizes=(4,),
                          store=f"sqlite://{tmp_path}/api.db",
                          time_source="analytic", repeats=1, device="cpu")
    tp3 = api.plan_single(MODEL, packed, batch_sizes=(4,), store=store,
                          time_source="analytic", repeats=1, device="cpu")
    assert store.stats()["hits"] > before
    for tp in (tp2, tp3):
        assert tp.config.layer_configs == tp1.config.layer_configs
        assert tp.table.times == tp1.table.times
