"""The port's fleet co-serving (``repro_torch.fleet``) against the JAX
package's ``repro.fleet``, on the same tables and the same traffic.

Equal, not within a tolerance: ``map_fleet``'s plan (every tenant's
configuration JSON, shares, inflations and makespans, the rounds and
convergence) on tables moved across packages as JSON, Hypothesis over
random tables included; ``joint_makespan``, ``tenant_inflations`` and
the all-GPU baseline; the ``DeviceTimeLedger``'s snapshot, shares and
step rows under the same observations; the ``FleetRouter``'s admission
decisions, dispatch order and ``stats()`` under one fake clock, cold
and on live telemetry; a two-tenant co-serve whose answers equal the
JAX package's ``forward_packed`` and its router's answers.  Mirrors
``tests/test_fleet.py`` on CPU tensors."""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from fixtures import (  # noqa: E402
    FakeClock,
    flat_table,
    observe_segments,
    random_split_table,
    tied_table,
)

from repro import adapt as R_A  # noqa: E402
from repro import estimator as R_E  # noqa: E402
from repro import fleet as R_F  # noqa: E402
from repro.bnn import models as R_M  # noqa: E402
from repro.core import mapper as R_MAP  # noqa: E402
from repro.core.profiler import ProfileTable as R_Table  # noqa: E402
from repro.serving import ServingEngine as R_Engine  # noqa: E402
from repro.serving import canonical_mixed_mapping as r_mixed  # noqa: E402
from repro_torch import adapt as T_A  # noqa: E402
from repro_torch import estimator as T_E  # noqa: E402
from repro_torch import fleet as T_F  # noqa: E402
from repro_torch.bnn import models as T_M  # noqa: E402
from repro_torch.core import mapper as T_MAP  # noqa: E402
from repro_torch.core.mapper import DEVICE, HOST  # noqa: E402
from repro_torch.core.parallel_config import CPU  # noqa: E402
from repro_torch.core.profiler import ProfileTable  # noqa: E402
from repro_torch.serving import ServingEngine, canonical_mixed_mapping  # noqa: E402

BATCH = 4


def _port(table):
    """A reference ProfileTable moved into the port as JSON."""
    return ProfileTable.from_json(table.to_json())


def _cfg(config) -> dict:
    return json.loads(config.to_json())


def _plan_doc(plan) -> dict:
    """Every field of a FleetPlan, configurations as JSON dicts."""
    return {
        "tenants": [
            {**{f.name: getattr(t, f.name)
                for f in dataclasses.fields(t)
                if f.name not in ("config", "law")},
             "config": _cfg(t.config)}
            for t in plan.tenants
        ],
        "joint": plan.joint_makespan_s,
        "baseline": plan.baseline_makespan_s,
        "rounds": plan.rounds,
        "converged": plan.converged,
    }


def _both_fleet(tables, **kw):
    """(port plan, reference plan) of the same reference tables."""
    got = T_F.map_fleet([_port(t) for t in tables], **kw)
    want = R_F.map_fleet(tables, **kw)
    return got, want


# ---------------------------------------------------------------------------
# joint mapper
# ---------------------------------------------------------------------------


def test_device_configs_and_map_all_device_equal_reference():
    t = tied_table("m", cpu=0.1, gpu=5.0)    # CPU strictly better solo
    assert T_F.device_configs(_port(t)) == R_F.device_configs(t)
    assert CPU not in T_F.device_configs(_port(t))
    got = T_F.map_all_device(_port(t))
    assert _cfg(got) == _cfg(R_F.map_all_device(t))
    assert all(c != CPU for c in got.layer_configs)
    free = T_MAP.map_efficient_configuration(_port(t), policy="dp")
    assert all(c == CPU for c in free.layer_configs)
    host_only = ProfileTable(
        "h", (4,), ("L1:C64",), {4: [{CPU: 1.0}]},
        kernel_times={4: [{CPU: 1.0}]},
        h2d_times={4: [0.0]}, d2h_times={4: [0.0]},
    )
    with pytest.raises(ValueError, match="device"):
        T_F.device_configs(host_only)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_map_fleet_equal_to_reference_and_never_worse(seed):
    """On random tables the port's joint plan is the reference's, and
    its makespan is never worse than the all-GPU assignment's."""
    rng = np.random.default_rng(seed)
    tables = [random_split_table(rng, name="a"),
              random_split_table(rng, name="b")]
    gamma = float(rng.uniform(0.2, 2.0))
    got, want = _both_fleet(tables, gamma=gamma)
    assert _plan_doc(got) == _plan_doc(want)
    ports = [_port(t) for t in tables]
    baseline = T_F.joint_makespan(
        ports, [T_F.map_all_device(t) for t in ports], gamma=gamma)
    assert got.baseline_makespan_s == baseline
    assert got.joint_makespan_s <= baseline + 1e-12
    assert got.vs_all_gpu <= 1.0 + 1e-9
    assert got.joint_makespan_s == T_F.joint_makespan(
        ports, got.configs, gamma=gamma)


CASES = {
    "tied_split": ([("a", {}), ("b", {})], {"gamma": 1.0}),
    "single_tenant": ([("solo", {"cpu": 0.5})], {}),
    "measured_shares": ([("a", {}), ("b", {})],
                        {"shares": [(0.0, 0.0), None], "gamma": 1.0}),
    "weighted": ([("a", {}), ("b", {})], {"weights": (10.0, 1.0)}),
    "named_three": ([("a", {}), ("b", {"gpu": 0.7}), ("c", {"cpu": 0.8})],
                    {"names": ("x", "y", "z"), "gamma": 0.5}),
    "greedy_one_round": ([("a", {}), ("b", {})],
                         {"policy": "greedy", "max_rounds": 1}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_map_fleet_cases_equal_to_reference(case):
    specs, kw = CASES[case]
    tables = [tied_table(name, **t) for name, t in specs]
    got, want = _both_fleet(tables, **kw)
    assert _plan_doc(got) == _plan_doc(want)
    assert got.joint_makespan_s <= got.baseline_makespan_s
    if case == "tied_split":
        placements = [{HOST if c == CPU else DEVICE
                       for c in t.config.layer_configs}
                      for t in got.tenants]
        assert all(len(p) == 1 for p in placements)
        assert placements[0] != placements[1]
        assert got.joint_makespan_s < got.baseline_makespan_s * 0.75
    if case == "measured_shares":
        assert got.tenants[1].device_inflation == 1.0


def test_map_fleet_with_a_fitted_law_equal_to_reference():
    knots = ((0.2, 1.3), (0.5, 1.3), (1.0, 1.9))
    tables = [tied_table("a"), tied_table("b", gpu=0.8)]
    got = T_F.map_fleet([_port(t) for t in tables],
                        law=T_E.FittedInterference(gamma=0.5, knots=knots))
    want = R_F.map_fleet(tables,
                         law=R_E.FittedInterference(gamma=0.5, knots=knots))
    assert _plan_doc(got) == _plan_doc(want)
    assert all(t.law is not None for t in got.tenants)


def test_tenant_inflations_and_joint_makespan_equal_to_reference():
    shares = [(0.25, 0.75), (1.0, 0.0), (0.0, 1.0)]
    for i in range(3):
        for gamma in (0.0, 1.0, 2.0):
            assert T_F.tenant_inflations(shares, i, gamma=gamma) == (
                R_F.tenant_inflations(shares, i, gamma=gamma))
    assert T_F.tenant_inflations(shares, 1, gamma=2.0) == (1.5, 4.5)
    tables = [tied_table("a"), tied_table("b")]
    mapping = (CPU, "XYZ", "XYZ", CPU)
    got = T_F.joint_makespan(
        [_port(t) for t in tables],
        [T_MAP.price_mapping(_port(t), 4, mapping) for t in tables],
        weights=(2.0, 1.0), shares=[None, (0.5, 0.5)])
    want = R_F.joint_makespan(
        tables, [R_MAP.price_mapping(t, 4, mapping) for t in tables],
        weights=(2.0, 1.0), shares=[None, (0.5, 0.5)])
    assert got == want


def test_map_fleet_validates():
    t = _port(tied_table("a"))
    with pytest.raises(ValueError):
        T_F.map_fleet([])
    with pytest.raises(ValueError, match="names"):
        T_F.map_fleet([t], names=("a", "b"))
    with pytest.raises(ValueError, match="shares"):
        T_F.map_fleet([t], shares=[(0, 1), (0, 1)])
    with pytest.raises(ValueError, match="weights"):
        T_F.map_fleet([t], weights=(1.0, 2.0))


# ---------------------------------------------------------------------------
# device-time ledger
# ---------------------------------------------------------------------------


class _Seg:
    def __init__(self, placement):
        self.placement = placement


def _ledger_ops(led):
    obs_a = led.observer("a")
    obs_a(0, _Seg(HOST), 1.0, 4)
    obs_a(1, _Seg(DEVICE), 3.0, 4)
    led.close_step("a")
    led.record("b", DEVICE, 2.0)
    led.close_step("b")
    led.record("c", HOST, 0.5)               # open, never closed
    led.record("a", HOST, -1.0)              # clamped to 0
    led.close_step("a")
    led.close_step("idle")                   # nothing open: no-op
    return led


def test_ledger_snapshot_shares_and_rows_equal_to_reference():
    got = _ledger_ops(T_F.DeviceTimeLedger())
    want = _ledger_ops(R_F.DeviceTimeLedger())
    assert got.tenants() == want.tenants() == ("a", "b", "c")
    assert got.snapshot() == want.snapshot()
    assert got.shares() == want.shares()
    for t in ("a", "b", "c", "idle"):
        assert got.usage(t) == T_F.TenantUsage(**dataclasses.asdict(
            want.usage(t)))
        assert got.step_rows(t) == want.step_rows(t)
        for p in (HOST, DEVICE):
            assert got.co_runner_share(t, p) == want.co_runner_share(t, p)
    assert got.shares()["a"] == (0.25, 0.75)
    got.reset("a")
    want.reset("a")
    assert got.snapshot() == want.snapshot()
    got.reset()
    assert got.tenants() == ()


def test_ledger_window_bounds_history():
    leds = [T_F.DeviceTimeLedger(window=4), R_F.DeviceTimeLedger(window=4)]
    for led in leds:
        for i in range(10):
            led.record("a", HOST if i < 8 else DEVICE, 1.0)
            led.close_step("a")
    assert leds[0].snapshot() == leds[1].snapshot()
    u = leds[0].usage("a")
    assert (u.steps, u.host_s, u.device_s) == (4, 2.0, 2.0)
    with pytest.raises(ValueError):
        T_F.DeviceTimeLedger(window=0)


def test_ledger_feeds_interference_fit_as_the_reference_does():
    """The port's own ledger, fed the planted-gamma trace, harvests
    the observations the reference's ledger harvests."""
    from fixtures import DEFAULT_OCCUPANCIES

    gamma = 0.8
    leds = [T_F.DeviceTimeLedger(window=8), R_F.DeviceTimeLedger(window=8)]
    shares = {t: (h / (h + d), d / (h + d))
              for t, (h, d) in DEFAULT_OCCUPANCIES.items()}
    expected = {}
    for t, (h, d) in DEFAULT_OCCUPANCIES.items():
        co_h = sum(s[0] for u, s in shares.items() if u != t)
        co_d = sum(s[1] for u, s in shares.items() if u != t)
        expected[t] = (h / (1 + gamma * co_h), d / (1 + gamma * co_d))
    for led in leds:
        for _ in range(6):
            for t, (h, d) in DEFAULT_OCCUPANCIES.items():
                led.record(t, HOST, h)
                led.record(t, DEVICE, d)
                led.close_step(t)
    got, want = T_E.InterferenceFit(), R_E.InterferenceFit()
    assert got.add_ledger(leds[0], expected) == want.add_ledger(
        leds[1], expected) > 0
    assert [vars(o) for o in got.observations()] == [
        vars(o) for o in want.observations()]
    assert got.fit().gamma == pytest.approx(gamma, abs=1e-9)


# ---------------------------------------------------------------------------
# the router: two tenants in both packages
# ---------------------------------------------------------------------------


_S: dict = {}


def _models():
    """{name: (reference model, reference packed, port model, port
    packed, reference table)} for two Fashion-MNIST widths."""
    if not _S:
        for name, scale, seed in (("small", 0.25, 0), ("large", 0.375, 1)):
            r = R_M.build_model("fashion_mnist", scale=scale)
            fp = T_M.random_fp_params(r.specs, seed)
            r_packed = R_M.pack_params(r.specs, fp)
            m = T_M.build_model("fashion_mnist", scale=scale)
            packed = T_M.pack_params(m.specs, fp, device="cpu")
            _S[name] = (r, r_packed, m, packed, flat_table(r, batch=BATCH))
    return _S


def _configs(name):
    r, _, m, _, r_table = _models()[name]
    r_ec = R_MAP.price_mapping(r_table, BATCH, r_mixed(r))
    ec = T_MAP.price_mapping(_port(r_table), BATCH,
                             canonical_mixed_mapping(m))
    assert _cfg(ec) == _cfg(r_ec)
    return ec, r_ec


def _engines(name, clock, **kw):
    """(port engine, reference engine) for tenant `name`."""
    r, r_packed, m, packed, r_table = _models()[name]
    ec, r_ec = _configs(name)
    t_kw = {k: v[0] if isinstance(v, tuple) else v for k, v in kw.items()}
    r_kw = {k: v[1] if isinstance(v, tuple) else v for k, v in kw.items()}
    return (
        ServingEngine(m, packed, ec, allowed_batch_sizes=(BATCH,),
                      clock=clock, device="cpu", **t_kw),
        R_Engine(r, r_packed, r_ec, allowed_batch_sizes=(BATCH,),
                 clock=clock, **r_kw),
    )


def _inputs(n, seed, name="small"):
    r, r_packed = _models()[name][:2]
    x01 = np.random.default_rng(seed).random((n, 28, 28, 1),
                                             dtype=np.float32)
    xw = np.asarray(R_M.prepare_input_packed(jnp.asarray(x01)))
    return xw, np.asarray(R_M.forward_packed(r.specs, r_packed, xw))


def test_router_admission_and_stats_equal_to_reference():
    clock = FakeClock()
    routers = (T_F.FleetRouter(), R_F.FleetRouter())
    ec, _ = _configs("small")
    step_s = ec.expected_time_per_example * ec.proper_batch_size
    for router, eng in zip(routers, _engines("small", clock)):
        router.add_tenant("a", eng, deadline_s=1.5 * step_s)
    for router, eng in zip(routers, _engines("small", clock)):
        router.add_tenant("b", eng)          # no deadline: never sheds
    xw, _ = _inputs(1, 0)
    decisions = [[router.submit(name, xw[0]) is not None
                  for name in ("a",) * 6 + ("b",) * 9]
                 for router in routers]
    assert decisions[0] == decisions[1]
    assert decisions[0][:6] == [True] * 4 + [False] * 2
    assert all(decisions[0][6:])
    assert routers[0].stats() == routers[1].stats()
    a = routers[0].tenant("a")
    assert (a.admitted, a.rejected) == (4, 2)
    with pytest.raises(ValueError):
        routers[0].add_tenant("a", a.engine)
    with pytest.raises(ValueError):
        routers[0].add_tenant("c", a.engine, deadline_s=0.0)
    with pytest.raises(ValueError, match="live_min_samples"):
        routers[0].add_tenant("c", a.engine, live_min_samples=0)


def test_router_dispatch_order_priority_then_deadline():
    orders = []
    for pkg, i in ((T_F, 0), (R_F, 1)):
        clock = FakeClock()
        router = pkg.FleetRouter()
        for name, prio, dl in (("low", 0, 1.0), ("hi", 5, math.inf),
                               ("tight", 0, 0.5)):
            eng = _engines("small", clock)[i]
            router.add_tenant(name, eng, priority=prio, deadline_s=dl)
            eng.submit(_inputs(1, 1)[0][0])
        orders.append([t.name for t in router._dispatch_order(force=True)])
        assert router._dispatch_order(force=False) == []
    assert orders[0] == orders[1] == ["hi", "tight", "low"]


def test_router_co_serves_two_models_bit_exact_with_the_reference():
    """Two tenants behind one router + ledger in each package,
    interleaved traffic: the port's answers equal the reference's
    forward and its router's answers; both ledgers metered the same
    steps, host and device both nonzero."""
    n = 8
    routers, ledgers, reqs = [], [], []
    for i, pkg in enumerate((T_F, R_F)):
        ledger = pkg.DeviceTimeLedger()
        router = pkg.FleetRouter(ledger=ledger)
        for name in ("small", "large"):
            eng = _engines(name, FakeClock(),
                           observer=(ledger.observer(name),) * 2)[i]
            router.add_tenant(name, eng,
                              priority=1 if name == "small" else 0)
        routers.append(router)
        ledgers.append(ledger)
    xs = {name: _inputs(n, 2 + k, name)
          for k, name in enumerate(("small", "large"))}
    for router in routers:
        got = {"small": [], "large": []}
        for j in range(n):
            for name in ("small", "large"):
                r = router.submit(name, xs[name][0][j])
                assert r is not None
                got[name].append(r)
        assert router.drain() == {"small": n, "large": n}
        reqs.append(got)
    for name in ("small", "large"):
        for j in range(n):
            port = reqs[0][name][j].wait(timeout=30)
            assert np.array_equal(port, xs[name][1][j])
            assert np.array_equal(port, np.asarray(
                reqs[1][name][j].wait(timeout=30)))
    assert routers[0].stats() == routers[1].stats()
    snaps = [led.snapshot() for led in ledgers]
    assert {t: s["steps"] for t, s in snaps[0].items()} == {
        t: s["steps"] for t, s in snaps[1].items()}
    for name in ("small", "large"):
        u = ledgers[0].usage(name)
        assert u.steps >= 1 and u.host_s > 0.0 and u.device_s > 0.0
    assert (ledgers[0].co_runner_share("small", HOST)
            + ledgers[0].co_runner_share("small", DEVICE)) == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# live-telemetry admission
# ---------------------------------------------------------------------------


def _telemetry_routers(min_samples=3):
    """One-tenant routers in both packages, each engine with its own
    SegmentTelemetry and a frozen clock; the tests feed telemetry
    directly, after (never before) any real observation."""
    ec, _ = _configs("small")
    step_s = ec.expected_time_per_example * ec.proper_batch_size
    out = []
    tels = (T_A.SegmentTelemetry(warmup=0, tenant="a"),
            R_A.SegmentTelemetry(warmup=0, tenant="a"))
    engines = _engines("small", FakeClock(), telemetry=tels)
    for pkg, eng, tel in zip((T_F, R_F), engines, tels):
        router = pkg.FleetRouter()
        tenant = router.add_tenant("a", eng, deadline_s=1.5 * step_s,
                                   live_min_samples=min_samples)
        out.append((router, tenant, tel, eng.config))
    return out, step_s


def test_router_admission_cold_then_live_equal_to_reference():
    rigs, step_s = _telemetry_routers()
    for router, tenant, tel, ec in rigs:
        assert tenant.live_step_s() is None
        assert tenant.step_expected_s() == step_s
        assert router.stats()["a"]["admission"] == "profiled"
        observe_segments(tel, ec, {}, n=2)
        assert tenant.live_step_s() is None
        observe_segments(tel, ec, {}, n=1)
        assert router.stats()["a"]["admission"] == "live"
    assert rigs[0][1].live_step_s() == rigs[1][1].live_step_s()
    assert rigs[0][1].live_step_s() == pytest.approx(step_s, rel=1e-6)
    for router, tenant, tel, _ in rigs:
        tel.reset()
        assert tenant.live_step_s() is None
        assert router.stats()["a"]["admission"] == "profiled"


@pytest.mark.parametrize("slow", [1.0, 10.0])
def test_router_live_admission_decisions_equal_to_reference(slow):
    """Quiet telemetry sheds exactly as profiled admission does (4 fit,
    the 5th sheds); segments ~10x slower shed the first request, and a
    sustained return to speed re-admits — the same decisions in both
    packages."""
    rigs, step_s = _telemetry_routers()
    xw, _ = _inputs(1, 0)
    decisions = []
    for router, tenant, tel, ec in rigs:
        observe_segments(tel, ec, {}, n=1)
        factors = {i: slow for i in range(len(ec.segments()))}
        observe_segments(tel, ec, factors, n=8)
        got = [router.submit("a", xw[0]) is not None for _ in range(5)]
        observe_segments(tel, ec, {}, n=24)
        got.append(router.submit("a", xw[0]) is not None)
        decisions.append((got, tenant.admitted, tenant.rejected,
                          tenant.live_step_s()))
    assert decisions[0] == decisions[1]
    if slow == 1.0:
        assert decisions[0][0] == [True] * 4 + [False, False]
    else:
        assert decisions[0][0][0] is False
        assert rigs[0][1].live_step_s() == pytest.approx(step_s, rel=0.1)


def test_router_on_a_live_engine_stays_bit_exact_after_real_steps():
    """Real steps first, synthetic telemetry after: the router's
    admission turns live and its answers stay equal to the
    reference's forward."""
    ec, _ = _configs("small")
    tel = T_A.SegmentTelemetry(warmup=0, tenant="a")
    eng = _engines("small", FakeClock(), telemetry=(tel, None))[0]
    router = T_F.FleetRouter(ledger=T_F.DeviceTimeLedger())
    router.add_tenant("a", eng, deadline_s=100.0)
    xw, want = _inputs(8, 5)
    reqs = [router.submit("a", x) for x in xw]
    assert router.drain() == {"a": 8}
    assert all(np.array_equal(r.wait(timeout=30), want[j])
               for j, r in enumerate(reqs))
    observe_segments(tel, ec, {}, n=3)
    assert router.stats()["a"]["admission"] == "live"
    assert router.ledger.tenants() == ()     # no observer attached


def test_all_device_configuration_shim_names_the_api():
    from repro_torch import _compat

    t = tied_table("m")
    _compat.reset_warned()
    with pytest.warns(DeprecationWarning,
                      match=r"repro_torch\.api\.map_all_device"):
        got = T_F.all_device_configuration(_port(t))
    _compat.reset_warned()
    assert _cfg(got) == _cfg(R_F.map_all_device(t))


def test_tables_cross_packages_unchanged():
    rng = np.random.default_rng(0)
    t = random_split_table(rng)
    assert json.loads(_port(t).to_json()) == json.loads(t.to_json())
    assert isinstance(R_Table.from_json(_port(t).to_json()), R_Table)
