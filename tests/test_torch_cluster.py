"""The port's cluster tier (``repro_torch.cluster``) and
``MicroBatcher.migrate_to`` against the JAX package's, on the same
tables, fake engines and fake clock.

Equal, not within a tolerance: the blake2b ring (the host
``ConsistentHash`` picks for 1,000 keys, before and after a scale-up),
``place_tenants``' ``ClusterPlan.to_dict()`` and per-tenant
configurations, the ``ElasticController`` journal and ``stats()`` of
whole scaling scenarios, the queue order ``migrate_to`` leaves; and a
drain with real engines on CPU tensors whose every answer, migrated or
not, equals the JAX package's ``forward_packed``.  Mirrors
``tests/test_cluster.py`` and the cluster cases of
``tests/test_elastic.py``."""

from __future__ import annotations

import json
import os
import random
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from fixtures import FakeClock, flat_table, tied_table  # noqa: E402
from tests.test_cluster import FakeEngine  # noqa: E402
from tests.test_elastic import _ElasticFakeEngine  # noqa: E402

from repro import api as R_API  # noqa: E402
from repro import cluster as R_CL  # noqa: E402
from repro.bnn import models as R_M  # noqa: E402
from repro.cluster import dispatch as R_D  # noqa: E402
from repro.core import mapper as R_MAP  # noqa: E402
from repro.serving import batcher as R_B  # noqa: E402
from repro_torch import api as T_API  # noqa: E402
from repro_torch import cluster as T_CL  # noqa: E402
from repro_torch.bnn import models as T_M  # noqa: E402
from repro_torch.cluster import dispatch as T_D  # noqa: E402
from repro_torch.core import mapper as T_MAP  # noqa: E402
from repro_torch.core.parallel_config import CPU  # noqa: E402
from repro_torch.core.profiler import ProfileTable  # noqa: E402
from repro_torch.serving import batcher as T_B  # noqa: E402

PKGS = {
    "port": (T_CL, T_API, T_MAP, lambda t: ProfileTable.from_json(
        t.to_json())),
    "reference": (R_CL, R_API, R_MAP, lambda t: t),
}


def _fake_tenant(pkg, name, *, cpu=1.0, gpu=0.9, weight=1.0):
    _, api, mapper, conv = PKGS[pkg]
    table = conv(tied_table(name, cpu=cpu, gpu=gpu))
    config = mapper.price_mapping(table, 4, [CPU] * len(table.layer_labels))
    return api.TenantPlan(name=name, model=None, packed=[], table=table,
                          config=config, weight=weight)


def _fake_cluster(pkg, names=("a",), *, n_hosts=2, step_cost_s=0.0,
                  elastic_engines=False, **kwargs):
    cl = PKGS[pkg][0]
    clock = FakeClock()

    def factory(tp, config, **_kw):
        if elastic_engines:
            return _ElasticFakeEngine(config, clock=clock,
                                      step_cost_s=step_cost_s)
        return FakeEngine(config, clock=clock, step_cost_s=step_cost_s)

    if pkg == "port":
        kwargs.setdefault("device", "cpu")
    tenants = [_fake_tenant(pkg, n) for n in names]
    return clock, cl.Cluster(tenants, n_hosts=n_hosts, engine_factory=factory,
                             clock=clock, batch_sizes=(4,), **kwargs)


def _stats(cluster) -> dict:
    """``stats()`` as JSON (tuples become lists in both packages)."""
    return json.loads(json.dumps(cluster.stats(), default=str))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_ring_hash_and_policies_equal_to_reference():
    for tok in ("", "0:0", "a:key17", "tenant-x:9999", "ü:ß"):
        assert T_D._ring_hash(tok) == R_D._ring_hash(tok)
    assert isinstance(T_CL.make_policy("least_loaded"), T_CL.LeastLoaded)
    assert isinstance(T_CL.make_policy("consistent_hash"),
                      T_CL.ConsistentHash)
    custom = T_CL.LeastLoaded()
    assert T_CL.make_policy(custom) is custom
    with pytest.raises(ValueError, match="unknown routing policy"):
        T_CL.make_policy("random")
    with pytest.raises(ValueError):
        T_CL.ConsistentHash(replicas=0)
    with pytest.raises(LookupError):
        T_CL.LeastLoaded().choose([], "a")


def test_consistent_hash_picks_the_reference_host_for_1000_keys():
    keys = [f"key{i}" for i in range(1000)]
    picks = {}
    for pkg in PKGS:
        cl = PKGS[pkg][0]
        _, cluster = _fake_cluster(pkg, n_hosts=1,
                                   policy=cl.ConsistentHash(replicas=32))
        cluster.scale_up()
        cluster.scale_up()
        before = [cluster.policy.choose(cluster.active_hosts(), "a",
                                        key=k).host_id for k in keys]
        cluster.scale_up()
        after = [cluster.policy.choose(cluster.active_hosts(), "a",
                                       key=k).host_id for k in keys]
        picks[pkg] = (before, after)
    assert picks["port"] == picks["reference"]
    before, after = picks["port"]
    assert set(before) == {0, 1, 2} and set(after) == {0, 1, 2, 3}
    assert sum(b != a for b, a in zip(before, after)) <= len(keys) // 2


def test_least_loaded_and_keyless_fallback():
    _, cluster = _fake_cluster("port", n_hosts=1,
                               policy=T_CL.ConsistentHash(replicas=8))
    host0 = cluster.hosts[0]
    host1, moved = cluster.scale_up()
    assert moved == ("a",)
    for _ in range(3):
        host0.submit("a", 0)
    assert cluster.policy.choose(cluster.active_hosts(), "a") is host1
    cluster.submit("a", 1)
    assert host1.pending() == 1
    cluster.drain()


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("names,n_hosts", [
    (("a", "b"), 1), (("a", "b"), 2), (("a", "b", "c"), 2),
    (("a", "b", "c"), 3), (("a", "b", "c"), 4),
])
def test_place_tenants_equal_to_reference(names, n_hosts):
    weights = {"a": 1.0, "b": 2.0, "c": 0.5}
    plans = {}
    for pkg in PKGS:
        cl = PKGS[pkg][0]
        tenants = [_fake_tenant(pkg, n, weight=weights[n],
                                gpu=0.9 - 0.05 * i)
                   for i, n in enumerate(names)]
        plans[pkg] = cl.place_tenants(tenants, n_hosts, batch_sizes=(4,))
    got, want = plans["port"], plans["reference"]
    assert got.to_dict() == want.to_dict()
    for n in names:
        assert got.host_of(n) == want.host_of(n)
        assert json.loads(got.config_of(n).to_json()) == json.loads(
            want.config_of(n).to_json())
    with pytest.raises(ValueError, match="n_hosts"):
        T_CL.place_tenants([_fake_tenant("port", "a")], 0)


# ---------------------------------------------------------------------------
# the elastic pool controller: whole scenarios, equal journals
# ---------------------------------------------------------------------------


def _surge(cluster, names, n=8):
    for name in names:
        for i in range(n):
            cluster.submit(name, i)


def _scale_up_scenario(pkg):
    names = ("a", "b")
    clock, cluster = _fake_cluster(
        pkg, names, n_hosts=2, step_cost_s=0.5,
        elastic={"high_water": 0.6, "low_water": 0.01, "sustain": 2,
                 "max_hosts": 4})
    for _ in range(3):
        _surge(cluster, names)
        cluster.step(force=True)
        clock.advance(0.01)
    out = _stats(cluster)
    cluster.drain()
    return out


def _one_up_per_window_scenario(pkg):
    clock, cluster = _fake_cluster(
        pkg, ("a",), n_hosts=1, step_cost_s=0.5,
        elastic={"high_water": 0.5, "low_water": 0.01, "sustain": 3,
                 "max_hosts": 8})
    for _ in range(6):
        _surge(cluster, ("a",))
        cluster.step(force=True)
        clock.advance(0.01)
    cluster.drain()
    return _stats(cluster)


def _drain_retire_scenario(pkg):
    clock, cluster = _fake_cluster(
        pkg, ("a",), n_hosts=2,
        elastic={"high_water": 0.9, "low_water": 0.2, "sustain": 2,
                 "min_hosts": 1})
    for _ in range(3):
        cluster.step()
        clock.advance(0.1)
    cluster.submit("a", 0)
    assert cluster.pending() == 1
    cluster.drain()
    return _stats(cluster)


def _deferred_scenario(pkg):
    names = ("a", "b")
    clock, cluster = _fake_cluster(
        pkg, names, n_hosts=2, step_cost_s=0.5,
        elastic={"high_water": 0.5, "low_water": 0.01, "sustain": 1,
                 "max_hosts": 4})
    victim = cluster.hosts[0]
    name = victim.tenant_names()[0]
    cluster.start_drain(victim)
    victim.router.tenant(name).engine.submit(0)
    actions = []
    for _ in range(2):
        _surge(cluster, names)
        for h in cluster.active_hosts():
            h.step(force=True)
        clock.advance(0.01)
        actions.append(cluster.elastic.observe(cluster).action)
        cluster.drain()
    assert actions[0] == "deferred"
    return _stats(cluster)


def _width_then_scale_scenario(pkg):
    clock, cluster = _fake_cluster(
        pkg, ("a",), n_hosts=1, step_cost_s=0.5, elastic_engines=True,
        elastic={"high_water": 0.5, "low_water": 0.01, "sustain": 2,
                 "max_hosts": 4})
    for _ in range(6):
        _surge(cluster, ("a",))
        cluster.step(force=True)
        clock.advance(0.01)
    cluster.drain()
    return _stats(cluster)


def _restore_then_drain_scenario(pkg):
    clock, cluster = _fake_cluster(
        pkg, ("a",), n_hosts=2, elastic_engines=True,
        elastic={"high_water": 0.9, "low_water": 0.2, "sustain": 2,
                 "min_hosts": 1})
    for h in cluster.active_hosts():
        for t in h.router.tenants():
            t.engine.level = 1               # planted quality debt
    for _ in range(4):
        cluster.step()
        clock.advance(0.1)
    cluster.drain()
    return _stats(cluster)


SCENARIOS = {
    "scale_up": (_scale_up_scenario, ["scale_up"]),
    "one_up_per_window": (_one_up_per_window_scenario,
                          ["scale_up", "scale_up"]),
    "drain_retire": (_drain_retire_scenario, ["drain", "retire"]),
    "deferred_then_retire": (_deferred_scenario, ["deferred", "retire"]),
    "width_then_scale": (_width_then_scale_scenario,
                         ["degrade_width", "scale_up"]),
    "restore_then_drain": (_restore_then_drain_scenario,
                           ["restore_width", "drain"]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_cluster_scenario_journal_and_stats_equal_to_reference(scenario):
    run, actions = SCENARIOS[scenario]
    got, want = run("port"), run("reference")
    assert got == want
    assert [r["action"] for r in got["elastic"]][:len(actions)] == actions


def test_elastic_controller_validates_knobs():
    for bad, match in (({"high_water": 0.2, "low_water": 0.5}, "low_water"),
                       ({"sustain": 0}, "sustain"),
                       ({"min_hosts": 5, "max_hosts": 2}, "min_hosts")):
        with pytest.raises(ValueError, match=match):
            T_CL.ElasticController(**bad)


def test_pool_guards_and_replication_hot_swaps():
    _, cluster = _fake_cluster("port", ("a",), n_hosts=1)
    with pytest.raises(RuntimeError, match="last active host"):
        cluster.start_drain(cluster.hosts[0])
    host = cluster.hosts[0]
    host.submit("a", 0)
    host.start_drain()
    with pytest.raises(RuntimeError, match="in-flight"):
        host.retire()
    with pytest.raises(RuntimeError, match="draining"):
        host.submit("a", 1)
    _, cluster = _fake_cluster("port", ("a", "b"), n_hosts=2)
    host0 = cluster.hosts[0]
    resident = host0.tenant_names()[0]
    before = host0.router.tenant(resident).engine
    other = next(n for n in ("a", "b") if n != resident)
    cluster._replicate(cluster.tenants[other], host0)
    assert host0.router.tenant(resident).engine is before
    assert before.swaps == 1


def test_remesh_state_names_the_open_item():
    """The cluster's ``remesh_state`` is the runtime's (queue 1 item
    12.4, ported); an empty tree plans and places nothing."""
    from repro_torch import configs
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.runtime.elastic import remesh_state

    assert T_CL.remesh_state is remesh_state
    cfg = configs.get_smoke("olmo_1b")
    assert T_CL.remesh_state(cfg, {}, abstract_mesh((1, 1))) == {}


def test_latency_quantile_equal_to_reference():
    rng = random.Random(0)
    for n in (0, 1, 7, 100):
        xs = [rng.random() for _ in range(n)]
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert T_CL.latency_quantile(xs, q) == R_CL.latency_quantile(
                xs, q)
    assert T_CL.latency_quantile(list(range(1, 101)), 0.99) == 99


# ---------------------------------------------------------------------------
# migrate_to: queue order as the reference leaves it
# ---------------------------------------------------------------------------


def _migrate(pkg):
    clock = FakeClock()
    src, dst = (pkg.MicroBatcher(max_batch=4, clock=clock) for _ in range(2))
    for i in range(6):
        (src if i % 2 == 0 else dst).submit(np.full((2,), i, np.int32))
        clock.advance(1.0)
    for i in range(6, 8):
        src.submit(np.full((2,), i, np.int32))
        clock.advance(0.5)
    assert src.migrate_to(src) == 0
    moved = src.migrate_to(dst)
    assert src.migrate_to(dst) == 0          # nothing left to move
    mb = dst.next_batch(force=True)
    rest = dst.next_batch(force=True)
    return moved, [(r.submit_t, int(r.x[0])) for b in (mb, rest)
                   for r in b.requests]


def test_migrate_to_orders_the_queue_as_the_reference_does():
    got = _migrate(T_B)
    assert got == _migrate(R_B)
    moved, order = got
    assert moved == 5
    assert [x for _, x in order] == list(range(8))
    assert [t for t, _ in order] == sorted(t for t, _ in order)


def test_migrate_to_under_concurrent_submitters_loses_nothing():
    """More submitter threads than cores on both batchers while the
    main thread migrates back and forth: every request ends in exactly
    one queue (a lost update or a nested-lock deadlock would break it)."""
    src, dst = T_B.MicroBatcher(max_batch=4), T_B.MicroBatcher(max_batch=4)
    n, per = (os.cpu_count() or 1) + 1, 50

    def submit(b, base):
        for i in range(per):
            b.submit(np.full((1,), base + i, np.int32))

    threads = [threading.Thread(target=submit,
                                args=((src, dst)[k % 2], 1000 * k))
               for k in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for _ in range(50):
            src.migrate_to(dst)
            dst.migrate_to(src)
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    seen = [int(r.x[0]) for b in (src.drain(), dst.drain())
            for mb in b for r in mb.requests]
    assert sorted(seen) == [1000 * k + i for k in range(n)
                            for i in range(per)]


# ---------------------------------------------------------------------------
# drain with real engines: every answer bit-exact
# ---------------------------------------------------------------------------


_REAL: dict = {}


def _real():
    if not _REAL:
        r = R_M.build_model("fashion_mnist", scale=0.25)
        fp = T_M.random_fp_params(r.specs, 0)
        r_packed = R_M.pack_params(r.specs, fp)
        m = T_M.build_model("fashion_mnist", scale=0.25)
        packed = T_M.pack_params(m.specs, fp, device="cpu")
        x01 = np.random.default_rng(7).integers(
            0, 2, size=(8, 28, 28, 1)).astype(np.float32)
        xw = np.asarray(R_M.prepare_input_packed(jnp.asarray(x01)))
        ref = np.asarray(R_M.forward_packed(r.specs, r_packed, xw))
        table = ProfileTable.from_json(flat_table(m).to_json())
        config = T_MAP.price_mapping(table, 4, [CPU] * len(table.layer_labels))
        _REAL["tp"] = T_API.TenantPlan(name=m.name, model=m, packed=packed,
                                       table=table, config=config)
        _REAL["io"] = (xw, ref)
    return _REAL["tp"], _REAL["io"]


def test_draining_host_migrates_queued_and_serves_bit_exact():
    tp, (xw, ref) = _real()
    cluster = T_CL.Cluster([tp], n_hosts=2, batch_sizes=(4,), device="cpu")
    victim = cluster.hosts[cluster.plan.host_of(tp.name)]
    reqs = [victim.submit(tp.name, xw[i]) for i in range(8)]
    moved = cluster.start_drain(victim)
    assert victim.status == T_CL.DRAINING and tp.name in moved
    assert victim.pending() == 0 and victim.drain() == {}
    victim.retire()
    assert victim.status == T_CL.RETIRED
    replica = cluster._hosts_for(tp.name)[0]
    assert replica.pending() == 8
    assert cluster.drain() == {tp.name: 8}
    for i, r in enumerate(reqs):
        assert r.done_t is not None
        np.testing.assert_array_equal(np.asarray(r.result), ref[i])
    r = cluster.submit(tp.name, xw[0])
    cluster.drain()
    np.testing.assert_array_equal(np.asarray(r.result), ref[0])


def test_drain_handoff_keeps_dispatched_work_on_the_draining_host():
    tp, (xw, ref) = _real()
    cluster = T_CL.Cluster([tp], n_hosts=2, batch_sizes=(4,), device="cpu")
    victim = cluster.hosts[cluster.plan.host_of(tp.name)]
    queued = [victim.submit(tp.name, xw[i]) for i in range(4)]
    cluster.start_drain(victim)
    stuck = victim.router.tenant(tp.name).engine.submit(xw[4])
    assert victim.pending() == 1
    assert victim.drain() == {tp.name: 1}
    victim.retire()
    np.testing.assert_array_equal(np.asarray(stuck.result), ref[4])
    cluster.drain()
    for i, r in enumerate(queued):
        np.testing.assert_array_equal(np.asarray(r.result), ref[i])


def test_migrate_queued_needs_a_replica():
    tp, (xw, _) = _real()
    cluster = T_CL.Cluster([tp], n_hosts=2, batch_sizes=(4,), device="cpu")
    src = cluster.hosts[cluster.plan.host_of(tp.name)]
    empty = next(h for h in cluster.hosts if h is not src)
    with pytest.raises(ValueError, match="no replica"):
        src.migrate_queued(tp.name, empty)
    src.submit(tp.name, xw[0])
    cluster._replicate(tp, empty)
    assert src.migrate_queued(tp.name, empty) == 1
    assert empty.drain() == {tp.name: 1}
