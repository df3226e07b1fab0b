"""The port's ``repro_torch.api`` facade against the JAX package's
``repro.api``: the verb set and its aliases, the deprecation shims
(now naming the facade: bit-exact, one warning per call site),
``plan_single`` / ``plan_fleet`` on stores seeded with the same tables
(equal configurations and fleet plans), and ``Deployment`` in single,
fleet (elastic and quality included) and cluster mode serving answers
equal to the JAX package's ``forward_packed``.  Mirrors
``tests/test_api.py`` on CPU tensors (that the facade's entry points
default to the card is checked in ``tests/test_torch_imports.py``)."""

from __future__ import annotations

import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from fixtures import flat_table, tied_table  # noqa: E402

import repro_torch.api as api  # noqa: E402
from repro import api as R_API  # noqa: E402
from repro import store as R_S  # noqa: E402
from repro.bnn import models as R_M  # noqa: E402
from repro_torch import _compat  # noqa: E402
from repro_torch import store as T_S  # noqa: E402
from repro_torch.bnn import models as T_M  # noqa: E402
from repro_torch.core.parallel_config import CPU  # noqa: E402
from repro_torch.core.profiler import ProfileTable  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_warn_sites():
    _compat.reset_warned()
    yield
    _compat.reset_warned()


_S: dict = {}


def _small(scale=0.25, seed=0):
    """(port model, port packed, reference model, reference packed,
    packed images, the reference's forward of them)."""
    key = (scale, seed)
    if key not in _S:
        r = R_M.build_model("fashion_mnist", scale=scale)
        fp = T_M.random_fp_params(r.specs, seed)
        r_packed = R_M.pack_params(r.specs, fp)
        m = T_M.build_model("fashion_mnist", scale=scale)
        packed = T_M.pack_params(m.specs, fp, device="cpu")
        x01 = np.random.default_rng(3).integers(
            0, 2, size=(8, 28, 28, 1)).astype(np.float32)
        xw = np.asarray(R_M.prepare_input_packed(jnp.asarray(x01)))
        ref = np.asarray(R_M.forward_packed(r.specs, r_packed, xw))
        _S[key] = (m, packed, r, r_packed, xw, ref)
    return _S[key]


def _port(table):
    return ProfileTable.from_json(table.to_json())


def _cfg(config):
    return json.loads(config.to_json())


def _seeded(tmp_path, models, batch=4):
    """A port and a reference store, each holding the same flat table
    of every (port model, reference model) pair: a warm start in both."""
    port = T_S.ProfileStore(f"dir://{tmp_path}/port", device="cpu")
    ref = R_S.ProfileStore(f"dir://{tmp_path}/ref")
    for m, r in models:
        port.save_profile(_port(flat_table(r, batch=batch)))
        ref.save_profile(flat_table(r, batch=batch))
    return port, ref


# ---------------------------------------------------------------------------
# the verb set
# ---------------------------------------------------------------------------


def test_verb_set_is_published_as_the_reference_does():
    assert api.__all__ == R_API.__all__
    for verb in api.__all__:
        assert hasattr(api, verb), verb
    for verb in ("profile_model", "autotune_model", "map_model", "map_fleet",
                 "map_all_device", "price_mapping", "fuse_mapping",
                 "plan_single", "plan_fleet", "Deployment"):
        assert callable(getattr(api, verb))


def test_aliases_are_the_implementations():
    from repro_torch.core.mapper import map_efficient_configuration
    from repro_torch.core.profiler import (
        autotune_bnn_model, profile_bnn_model,
    )
    from repro_torch.fleet.scheduler import map_all_device, map_fleet

    assert api.profile_model is profile_bnn_model
    assert api.autotune_model is autotune_bnn_model
    assert api.map_model is map_efficient_configuration
    assert api.map_fleet is map_fleet
    assert api.map_all_device is map_all_device


# ---------------------------------------------------------------------------
# deprecation shims: bit-exact with the facade, warn once per site
# ---------------------------------------------------------------------------


def _deprecations(caught):
    return [str(w.message) for w in caught
            if w.category is DeprecationWarning]


def test_configuration_from_mapping_shim_bit_exact():
    from repro_torch.core import configuration_from_mapping

    table = tied_table("m")
    mapping = [CPU, "XYZ", "XYZ", CPU]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        old = configuration_from_mapping(_port(table), 4, mapping)
    assert old == api.price_mapping(_port(table), 4, mapping)
    assert _cfg(old) == _cfg(R_API.price_mapping(table, 4, mapping))
    (msg,) = _deprecations(caught)
    assert "configuration_from_mapping" in msg
    assert "repro_torch.api.price_mapping" in msg


def test_all_device_configuration_shim_bit_exact():
    from repro_torch.fleet import all_device_configuration

    table = tied_table("m")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        old = all_device_configuration(_port(table))
    assert old == api.map_all_device(_port(table))
    assert _cfg(old) == _cfg(R_API.map_all_device(table))
    (msg,) = _deprecations(caught)
    assert "repro_torch.api.map_all_device" in msg


def test_fuse_configuration_shim_bit_exact():
    from repro_torch.core.plan import fuse_configuration

    m, packed, r, *_ = _small()
    table = _port(flat_table(r))
    config = api.price_mapping(table, 4, ["XYZ"] * len(table.layer_labels))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        old = fuse_configuration(m, packed, table, config,
                                 time_source="analytic", repeats=1)
    new = api.fuse_mapping(m, packed, _port(flat_table(r)), config,
                           time_source="analytic", repeats=1)
    assert old == new and old.fused_segments
    (msg,) = _deprecations(caught)
    assert "repro_torch.api.fuse_mapping" in msg


def test_shim_warns_once_per_call_site():
    from repro_torch.core import configuration_from_mapping

    table = _port(tied_table("m"))
    mapping = [CPU] * len(table.layer_labels)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(5):   # one site, many calls
            configuration_from_mapping(table, 4, mapping)
        configuration_from_mapping(table, 4, mapping)  # second site
    assert len(_deprecations(caught)) == 2


# ---------------------------------------------------------------------------
# planning helpers
# ---------------------------------------------------------------------------


def test_plan_single_maps_persists_and_warm_starts(tmp_path, monkeypatch):
    m, packed, *_ = _small()
    store = T_S.ProfileStore(tmp_path, device="cpu")
    tp = api.plan_single(m, packed, batch_sizes=(4,), store=store,
                         time_source="analytic", repeats=1, device="cpu")
    assert tp.config.proper_batch_size == 4 and tp.expected_s_per_example > 0
    assert store.load_profile(m, (4,)) is not None
    assert store.load_mapping(m, policy="dp", batch=4) is not None

    def boom(*a, **k):
        raise AssertionError("profiled on a warm start")

    monkeypatch.setattr(api, "profile_model", boom)
    tp2 = api.plan_single(m, packed, batch_sizes=(4,), store=store,
                          time_source="analytic", repeats=1, device="cpu")
    assert tp2.config == tp.config


@pytest.mark.parametrize("fuse", [False, True])
def test_plan_single_equal_to_reference_on_a_seeded_store(tmp_path, fuse):
    m, packed, r, r_packed, *_ = _small()
    port, ref = _seeded(tmp_path, [(m, r)])
    got = api.plan_single(m, packed, batch_sizes=(4,), store=port,
                          device="cpu")
    want = R_API.plan_single(r, r_packed, batch_sizes=(4,), store=ref)
    assert _cfg(got.config) == _cfg(want.config)
    assert got.name == want.name == m.name
    if fuse:
        fused = api.plan_single(m, packed, batch_sizes=(4,), store=port,
                                fuse=True, time_source="analytic",
                                device="cpu")
        assert fused.config.layer_configs == got.config.layer_configs


def test_plan_fleet_equal_to_reference_on_seeded_stores(tmp_path):
    a, b = _small(0.25, 0), _small(0.375, 1)
    port, ref = _seeded(tmp_path, [(a[0], a[2]), (b[0], b[2])])
    tenants, plan = api.plan_fleet(
        {"a": a[:2], "b": b[:2]}, batch_sizes=(4,), store=port,
        weights={"a": 2.0}, device="cpu")
    r_tenants, r_plan = R_API.plan_fleet(
        {"a": (a[2], a[3]), "b": (b[2], b[3])}, batch_sizes=(4,),
        store=ref, weights={"a": 2.0})
    assert plan.joint_makespan_s == r_plan.joint_makespan_s
    assert plan.baseline_makespan_s == r_plan.baseline_makespan_s
    assert plan.joint_makespan_s <= plan.baseline_makespan_s
    for name in ("a", "b"):
        assert _cfg(tenants[name].config) == _cfg(r_tenants[name].config)
        assert tenants[name].weight == r_tenants[name].weight
    with pytest.raises(ValueError, match="at least one"):
        api.plan_fleet({})


# ---------------------------------------------------------------------------
# Deployment
# ---------------------------------------------------------------------------


def _plan(models, **kw):
    kw.setdefault("batch_sizes", (4,))
    kw.setdefault("time_source", "analytic")
    return api.Deployment.plan(models, repeats=1, device="cpu", **kw)


def test_deployment_single_serves_bit_exact():
    m, packed, _, _, xw, ref = _small()
    dep = _plan((m, packed))
    assert dep.mode == "single"
    with pytest.raises(RuntimeError, match="serve"):
        dep.submit(xw[0])
    with pytest.raises(RuntimeError, match="serve"):
        dep.step()
    dep.serve(max_batch=4)
    reqs = [dep.submit(xw[i]) for i in range(8)]
    assert dep.drain() == 8
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(np.asarray(r.result), ref[i])
    s = dep.stats()
    assert s["mode"] == "single" and s["served"] == 8


def test_deployment_single_stats_report_rows_store_and_builds(tmp_path):
    from repro_torch.kernels import build

    m, packed, _, _, xw, ref = _small()
    store = T_S.ProfileStore(f"dir://{tmp_path}", device="cpu")
    _plan((m, packed), store=store)            # cold: profiles
    dep = _plan((m, packed), store=store).serve(max_batch=4)
    reqs = [dep.submit(xw[i]) for i in range(6)]
    assert dep.drain() == 6                    # 4, then 2 padded to 4
    assert dep.step() == 0
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(np.asarray(r.result), ref[i])
    s = dep.stats()
    assert (s["microbatches"], s["real_rows"], s["pad_rows"],
            s["empty_steps"]) == (2, 6, 2, 1)
    counts = store.stats()
    assert (s["store_hits"], s["store_misses"]) == (
        counts["hits"], counts["misses"])
    assert s["store_hits"] >= 1 and s["store_misses"] >= 1
    assert s["compiles"] == build.compiles
    assert "store_hits" not in _plan((m, packed)).serve().stats()


def test_deployment_fleet_equal_to_reference_and_bit_exact(tmp_path):
    m, packed, r, r_packed, xw, ref = _small()
    port, r_store = _seeded(tmp_path, [(m, r)])
    dep = api.Deployment.plan({"a": (m, packed), "b": (m, packed)},
                              batch_sizes=(4,), store=port, device="cpu")
    want = R_API.Deployment.plan({"a": (r, r_packed), "b": (r, r_packed)},
                                 batch_sizes=(4,), store=r_store)
    assert dep.mode == "fleet"
    for name in ("a", "b"):
        assert _cfg(dep.configuration(name)) == _cfg(want.configuration(name))
    with pytest.raises(ValueError, match="name one"):
        dep.configuration()
    dep.serve(max_batch=4)
    with pytest.raises(ValueError, match="tenant"):
        dep.submit(xw[0])
    reqs = {n: [dep.submit(xw[i], tenant=n) for i in range(4)]
            for n in ("a", "b")}
    assert dep.drain() == {"a": 4, "b": 4}
    for rs in reqs.values():
        for i, rq in enumerate(rs):
            np.testing.assert_array_equal(np.asarray(rq.result), ref[i])
    s = dep.stats()
    assert s["mode"] == "fleet" and set(s["tenants"]) == {"a", "b"}
    assert set(s["ledger"]) == {"a", "b"}


def test_deployment_fleet_with_an_elastic_tenant_and_quality():
    m, packed, _, _, xw, ref = _small()
    dep = _plan({"a": (m, packed), "b": (m, packed)},
                elastic={"a": (1.0, 0.5)}, quality_floors={"a": 1})
    tp = dep.tenants["a"]
    assert len(tp.elastic) == 2 and tp.quality_floor == 1
    assert tp.elastic.levels[0] is tp
    dep.serve(max_batch=4, quality={"degrade_after": 1})
    engine = dep.router.tenant("a").engine
    engine.set_level(1)
    narrow = tp.elastic.levels[1]
    want = T_M.forward_packed(narrow.model.specs, narrow.packed,
                              torch.from_numpy(xw.copy())).numpy()
    reqs = [dep.submit(xw[i], tenant="a") for i in range(4)]
    dep.drain()
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(np.asarray(r.result), want[i])
    s = dep.stats()
    assert s["tenants"]["a"]["level"] == 1 and s["quality"] == []
    assert not np.array_equal(want[:4], ref[:4])   # a narrower net
    with pytest.raises(ValueError, match="quality"):
        _plan((m, packed)).serve(quality=True)
    with pytest.raises(ValueError, match="match no tenant"):
        _plan({"a": (m, packed), "b": (m, packed)}, elastic={"z": (1.0, 0.5)})


def test_deployment_cluster_equal_to_reference_and_bit_exact(tmp_path):
    m, packed, r, r_packed, xw, ref = _small()
    port, r_store = _seeded(tmp_path, [(m, r)])
    dep = api.Deployment.plan({"a": (m, packed), "b": (m, packed)},
                              hosts=2, batch_sizes=(4,), store=port,
                              routing="consistent_hash", device="cpu")
    want = R_API.Deployment.plan({"a": (r, r_packed), "b": (r, r_packed)},
                                 hosts=2, batch_sizes=(4,), store=r_store,
                                 routing="consistent_hash")
    assert dep.mode == "cluster"
    dep.serve(max_batch=4)
    want.serve(max_batch=4)
    assert dep.cluster_plan.to_dict() == want.cluster_plan.to_dict()
    reqs = [dep.submit(xw[i], tenant="a", key=f"k{i}") for i in range(4)]
    dep.submit(xw[0], tenant="b", key="k0")
    served = dep.drain()
    assert served == {"a": 4, "b": 1}
    for i, rq in enumerate(reqs):
        np.testing.assert_array_equal(np.asarray(rq.result), ref[i])
    s = dep.stats()
    assert s["mode"] == "cluster" and s["n_active"] == 2
    assert s["cache"]["misses"] == 0


def test_deployment_validates_hosts():
    m, packed, *_ = _small()
    with pytest.raises(ValueError, match="hosts"):
        api.Deployment.plan((m, packed), hosts=0, device="cpu")
