"""The port's adaptive runtime (``repro_torch.adapt``) and BNN mapping
hillclimb against the JAX package's: the same observation stream gives
equal telemetry snapshots, equal drift reports, equal folded tables and
equal swap journals; served answers stay bit-exact against the JAX
package's ``forward_packed`` before, during and after every kind of
swap.  Mirrors the cases of ``tests/test_adapt.py`` on CPU tensors."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from fixtures import FakeClock, flat_table, observe_segments  # noqa: E402

from repro import adapt as R_A  # noqa: E402
from repro.bnn import models as R_M  # noqa: E402
from repro.core import mapper as R_MAP  # noqa: E402
from repro.core.parallel_config import CONFIGS, CPU  # noqa: E402
from repro.core.profiler import ProfileTable as R_Table  # noqa: E402
from repro.serving import ServingEngine as R_Engine  # noqa: E402
from repro.serving import canonical_mixed_mapping as r_mixed  # noqa: E402
from repro_torch import adapt as T_A  # noqa: E402
from repro_torch.bnn import models as T_M  # noqa: E402
from repro_torch.core import mapper as T_MAP  # noqa: E402
from repro_torch.core.profiler import ProfileTable  # noqa: E402
from repro_torch.kernels import registry as T_REG  # noqa: E402
from repro_torch.launch.hillclimb import bnn_mapping_hillclimb  # noqa: E402
from repro_torch.serving import ServingEngine, canonical_mixed_mapping  # noqa: E402

BATCH = 4
_S: dict = {}


@dataclasses.dataclass
class Pair:
    """One model in both packages, built from the same NumPy params."""

    r_model: object
    r_packed: list
    r_table: object
    r_ec: object
    model: object
    packed: list
    table: object
    ec: object


def _small() -> Pair:
    if not _S:
        r = R_M.build_model("fashion_mnist", scale=0.25)
        r_packed = R_M.pack_params(r.specs, T_M.random_fp_params(r.specs, 0))
        m = T_M.build_model("fashion_mnist", scale=0.25)
        packed = T_M.packed_params_from_numpy(
            [{k: np.asarray(v) for k, v in p.items()} for p in r_packed],
            device="cpu")
        r_table = flat_table(r)
        table = ProfileTable.from_json(r_table.to_json())
        r_ec = R_MAP.price_mapping(r_table, BATCH, r_mixed(r))
        ec = T_MAP.price_mapping(table, BATCH, canonical_mixed_mapping(m))
        assert json.loads(ec.to_json()) == json.loads(r_ec.to_json())
        _S["pair"] = Pair(r, r_packed, r_table, r_ec, m, packed, table, ec)
    return _S["pair"]


def _inputs(n, seed0=0):
    """`n` micro-batches of BATCH packed images (NumPy words) and the
    JAX package's ``forward_packed`` of each."""
    s = _small()
    out = []
    for i in range(n):
        x01 = np.random.default_rng(seed0 + i).random(
            (BATCH, 28, 28, 1), dtype=np.float32)
        xw = np.asarray(R_M.prepare_input_packed(jnp.asarray(x01)))
        want = np.asarray(R_M.forward_packed(s.r_model.specs, s.r_packed, xw))
        out.append((xw, want))
    return out


def _engine(ec=None, **kw):
    s = _small()
    return ServingEngine(s.model, s.packed, s.ec if ec is None else ec,
                         allowed_batch_sizes=s.table.batch_sizes,
                         clock=FakeClock(), device="cpu", **kw)


def _r_engine(**kw):
    s = _small()
    return R_Engine(s.r_model, s.r_packed, s.r_ec,
                    allowed_batch_sizes=s.r_table.batch_sizes,
                    clock=FakeClock(), **kw)


def _serve(engine, xw, want):
    reqs = [engine.submit(xw[j]) for j in range(BATCH)]
    return reqs, lambda: all(np.array_equal(r.wait(timeout=30), want[j])
                             for j, r in enumerate(reqs))


def _rows(reports):
    return [dataclasses.asdict(r) for r in reports]


def _table_doc(table):
    return json.loads(table.to_json())


# ---------------------------------------------------------------------------
# telemetry: both packages fed the same stream give the same snapshot
# ---------------------------------------------------------------------------


class _Seg:
    placement = "host"


def _both(**kw):
    return R_A.SegmentTelemetry(**kw), T_A.SegmentTelemetry(**kw)


def test_telemetry_sampling_cadence_and_warmup():
    for tel in _both(sample_every=2, warmup=1):
        got = [tel.sample() is not None for _ in range(6)]
        assert got == [False, True, False, True, False, True]
        tel.reset()
        assert tel.sample() is None          # warmup again after reset


def test_telemetry_disabled_is_never_sampled():
    for pkg in (R_A, T_A):
        assert pkg.SegmentTelemetry(enabled=False).sample() is None
        assert pkg.SegmentTelemetry(sample_every=0).sample() is None


def test_telemetry_stats_per_example_normalization():
    snaps = []
    for tel in _both(alpha=0.5, warmup=0):
        tel.on_segment(0, _Seg(), 8.0, 4)     # 2 s/example
        tel.flush()
        tel.on_segment(0, _Seg(), 4.0, 4)     # 1 s/example
        s = tel.observed(0)
        assert s.count == 2 and s.ewma == pytest.approx(1.5)
        assert s.recent_median(2) == pytest.approx(1.5)
        assert s.quantile(0.0) == 1.0 and s.quantile(1.0) == 2.0
        snaps.append(tel.snapshot())
        tel.reset()
        assert tel.observed(0) is None
    assert snaps[0] == snaps[1]
    assert snaps[1][0]["count"] == 2 and snaps[1][0]["placement"] == "host"


def test_telemetry_recent_median_ignores_single_outlier():
    for tel in _both(warmup=0):
        for v in (1.0, 1.0, 100.0):
            tel.on_segment(0, _Seg(), v, 1)
            tel.flush()
        assert tel.observed(0).recent_median(3) == 1.0


def test_telemetry_recent_floor_survives_outlier_runs():
    floors = []
    for tel in _both(warmup=0):
        got = []
        for vs in ((1.0, 50.0, 80.0), (40.0, 50.0, 60.0)):
            for v in vs:
                tel.on_segment(0, _Seg(), v, 1)
                tel.flush()
            got.append(tel.observed(0).recent_floor(3))
        floors.append(got)
    assert floors[0] == floors[1] == [1.0, 40.0]


def test_telemetry_aggregates_one_sample_per_step_and_segment():
    for tel in _both(warmup=0):
        for v in (9.0, 3.0, 7.0):            # three micro-batches, one step
            tel.on_segment(0, _Seg(), v, 1)
        s = tel.observed(0)                  # read flushes the step
        assert s.count == 1 and s.window[0] == 3.0


def test_telemetry_validates():
    for bad in ({"alpha": 0.0}, {"window": 0}, {"sample_every": -1},
                {"warmup": -1}):
        with pytest.raises(ValueError):
            T_A.SegmentTelemetry(**bad)


# ---------------------------------------------------------------------------
# drift detection: equal reports from equal streams
# ---------------------------------------------------------------------------


def _check_both(factors, n=8, **det_kw):
    """Feed both packages' telemetry `n` steps at `factors` x predicted;
    the reports and snapshots must be equal.  Returns (reference
    reports, port reports)."""
    s = _small()
    out = []
    for pkg, ec in ((R_A, s.r_ec), (T_A, s.ec)):
        tel = pkg.SegmentTelemetry(warmup=0)
        observe_segments(tel, ec, factors, n=n)
        out.append((pkg.DriftDetector(**det_kw).check(ec, tel), tel))
    (r_rep, r_tel), (t_rep, t_tel) = out
    assert _rows(t_rep) == _rows(r_rep)
    assert t_tel.snapshot() == r_tel.snapshot()
    return r_rep, t_rep


def test_no_drift_when_observed_matches_predicted():
    assert _check_both({}, min_samples=3)[1] == ()


def test_slow_batches_never_trigger_until_sustained():
    s = _small()
    pred = s.ec.segment_expected_times()
    verdicts = []
    for pkg, ec in ((R_A, s.r_ec), (T_A, s.ec)):
        tel = pkg.SegmentTelemetry(warmup=0)
        observe_segments(tel, ec, {}, n=6)
        det = pkg.DriftDetector(min_samples=3)
        got = []
        for _ in range(3):                   # the third slow batch sustains
            for idx, seg in enumerate(ec.segments()):
                tel.on_segment(idx, seg, pred[idx] * 1000 * 4, 4)
            got.append(_rows(det.check(ec, tel)))
        verdicts.append(got)
    assert verdicts[0] == verdicts[1]
    assert verdicts[1][0] == verdicts[1][1] == [] and verdicts[1][2]


def test_sustained_drift_is_reported_with_evidence():
    _, reports = _check_both({0: 5.0, 1: 5.0}, rel_threshold=0.5,
                             min_samples=3)
    s = _small()
    assert {r.segment_index for r in reports} == {0, 1}
    for r in reports:
        assert r.ratio == pytest.approx(5.0, rel=1e-6) and r.samples == 8
        assert r.placement == s.ec.segments()[r.segment_index].placement


def test_drift_needs_min_samples():
    assert _check_both({0: 5.0}, n=2, min_samples=3)[1] == ()
    assert _check_both({0: 5.0}, n=3, min_samples=3)[1] != ()


def test_drift_direction_and_threshold():
    assert _check_both({0: 0.1}, min_samples=3)[1] == ()
    both = _check_both({0: 0.1}, min_samples=3, direction="both")[1]
    assert [r.segment_index for r in both] == [0]
    assert _check_both({0: 1.3}, min_samples=3, rel_threshold=0.5,
                       direction="both")[1] == ()


def test_drift_min_share_keys_on_observed_too():
    _, reports = _check_both({0: 1000.0}, min_samples=3, min_share=0.5)
    assert [r.segment_index for r in reports] == [0]


def test_drift_gates_on_retained_window_not_lifetime_count():
    s = _small()
    for pkg, ec in ((R_A, s.r_ec), (T_A, s.ec)):
        tel = pkg.SegmentTelemetry(warmup=0, window=2)
        observe_segments(tel, ec, {0: 50.0}, n=20)   # count 20, retained 2
        assert pkg.DriftDetector(min_samples=3).check(ec, tel) == ()


def test_drift_detector_validates():
    for bad in ({"rel_threshold": 0.0}, {"min_samples": 0},
                {"direction": "sideways"}):
        with pytest.raises(ValueError):
            T_A.DriftDetector(**bad)


# ---------------------------------------------------------------------------
# profile folding: equal corrected tables
# ---------------------------------------------------------------------------


def test_fold_observed_changes_only_drifted_layers_same_placement():
    s = _small()
    r_reports, reports = _check_both({0: 3.0}, min_samples=3)
    assert len(reports) == 1
    corrected = T_A.fold_observed(s.table, s.ec, reports)
    r_corrected = R_A.fold_observed(s.r_table, s.r_ec, r_reports)
    assert _table_doc(corrected) == _table_doc(r_corrected)
    seg = s.ec.segments()[0]
    for b in s.table.batch_sizes:
        for i in range(len(s.table.layer_labels)):
            for c in s.table.configs_for(b, i):
                old = s.table.kernel_time(b, i, c)
                new = corrected.kernel_time(b, i, c)
                if seg.start <= i < seg.stop and (c == CPU) != seg.on_device:
                    assert new == pytest.approx(old * reports[0].ratio)
                else:
                    assert new == old
                assert corrected.times[b][i][c] == pytest.approx(
                    new + corrected.boundary_time(b, i, c))
    assert corrected.h2d_times == s.table.h2d_times
    assert corrected.d2h_times == s.table.d2h_times


def test_fold_observed_noop_without_reports():
    s = _small()
    assert T_A.fold_observed(s.table, s.ec, ()) is s.table


# ---------------------------------------------------------------------------
# engine hot swap: atomicity and the idle force-flush regression
# ---------------------------------------------------------------------------


def test_force_flush_on_idle_engine_is_noop():
    s = _small()
    tel = T_A.SegmentTelemetry(warmup=0)
    engine = _engine(telemetry=tel)
    for _ in range(3):
        assert engine.step(force=True) == 0
    assert engine.served == 0 and engine.steps == 0
    assert tel.stats() == {}
    ec2 = T_MAP.price_mapping(s.table, BATCH, (CPU,) * len(s.model.specs))
    engine._pending_swap = ec2
    assert engine.step(force=True) == 0
    assert engine.config is ec2 and engine.swaps == 1


def test_swap_between_steps_applies_immediately():
    s = _small()
    engine = _engine()
    old_pipe = engine.pipeline
    ec2 = T_MAP.price_mapping(s.table, BATCH, ("XYZ",) * len(s.model.specs))
    assert engine.swap_configuration(ec2) is True
    assert engine.config is ec2 and engine.pipeline is not old_pipe
    assert engine.swaps == 1


def test_swap_must_preserve_serving_batch_size():
    s = _small()
    engine = _engine()
    table2 = ProfileTable.from_json(flat_table(s.r_model, batch=2).to_json())
    other = T_MAP.price_mapping(table2, 2, canonical_mixed_mapping(s.model))
    with pytest.raises(ValueError, match="batch size"):
        engine.swap_configuration(other)
    assert engine.config is s.ec and engine.swaps == 0


def test_reprice_only_swap_reuses_pipeline():
    s = _small()
    engine = _engine()
    old_pipe = engine.pipeline
    repriced = dataclasses.replace(
        s.ec, expected_time_per_example=s.ec.expected_time_per_example * 2)
    assert engine.swap_configuration(repriced) is True
    assert engine.config is repriced
    assert engine.pipeline is old_pipe and engine.swaps == 1


def test_swap_requested_mid_step_is_deferred_to_batch_boundary():
    s = _small()
    engine = _engine()
    ec2 = T_MAP.price_mapping(s.table, BATCH, ("XYZ",) * len(s.model.specs))
    ins = _inputs(3)
    for xw, _ in ins:
        for j in range(BATCH):
            engine.submit(xw[j])
    seen = []
    real_run = engine.pipeline.run_pipelined

    def run_with_midstream_swap(inputs, *, on_complete=None, observer=None):
        def complete(i, out):
            if i == 0:
                assert engine.swap_configuration(ec2) is False  # deferred
            seen.append(engine.config)
            on_complete(i, out)

        return real_run(inputs, on_complete=complete, observer=observer)

    engine.pipeline.run_pipelined = run_with_midstream_swap
    assert engine.step(force=True) == 3 * BATCH
    assert all(c is s.ec for c in seen) and len(seen) == 3
    assert engine.config is ec2 and engine.swaps == 1


@settings(max_examples=5, deadline=None)
@given(swap_at=st.integers(0, 2), seed=st.integers(0, 2**31 - 1))
def test_outputs_bit_exact_before_during_after_swap(swap_at, seed):
    """For any swap point within a served stream — between steps, or
    requested mid-step and deferred — every answer equals the JAX
    package's forward_packed, and a reprice-only swap keeps serving
    through the same pipeline."""
    s = _small()
    ec2 = T_MAP.map_efficient_configuration(s.table, policy="dp")
    engine = _engine(telemetry=T_A.SegmentTelemetry(warmup=0))
    ins = _inputs(4, seed0=seed % 1000)
    for step_i, (xw, want) in enumerate(ins):
        if step_i == swap_at:
            engine.swap_configuration(ec2)
        if step_i == 3:                      # deferred: from a completion
            real_run = engine.pipeline.run_pipelined

            def run(inputs, *, on_complete=None, observer=None):
                def complete(i, out):
                    engine.swap_configuration(dataclasses.replace(
                        engine.config, expected_time_per_example=1.0))
                    on_complete(i, out)
                return real_run(inputs, on_complete=complete,
                                observer=observer)

            engine.pipeline.run_pipelined = run
        _, ok = _serve(engine, xw, want)
        assert engine.step(force=True) == BATCH and ok()
    assert engine.swaps == 2
    assert engine.config.expected_time_per_example == 1.0
    xw, want = ins[0]
    _, ok = _serve(engine, xw, want)
    assert engine.step(force=True) == BATCH and ok()


# ---------------------------------------------------------------------------
# controller: equal journals from equal streams
# ---------------------------------------------------------------------------


def _controllers(**ctl_kw):
    """(reference controller, port controller) over engines serving the
    mixed mapping, each with its own telemetry and fake clocks."""
    s = _small()
    out = []
    for pkg, make, table in ((R_A, _r_engine, s.r_table),
                             (T_A, _engine, s.table)):
        engine = make(telemetry=pkg.SegmentTelemetry(warmup=0))
        out.append(pkg.RemapController(
            engine, table, clock=FakeClock(),
            detector=pkg.DriftDetector(rel_threshold=0.5, min_samples=3),
            **ctl_kw))
    return out


def test_controller_remaps_on_drift_and_journals():
    s = _small()
    host_idx = [i for i, g in enumerate(s.ec.segments()) if not g.on_device]
    records = []
    for ctl in _controllers():
        assert ctl.maybe_remap() is None      # no samples -> no remap
        observe_segments(ctl.telemetry, ctl.engine.config,
                         {i: 50.0 for i in host_idx})
        rec = ctl.maybe_remap()
        assert rec is not None and ctl.journal == [rec]
        records.append(rec)
    r_rec, rec = records
    assert rec.to_dict() == r_rec.to_dict()
    ctl = _controllers()[1]
    observe_segments(ctl.telemetry, s.ec, {i: 50.0 for i in host_idx})
    rec = ctl.maybe_remap()
    engine = ctl.engine
    assert engine.swaps == 1 and engine.config is not s.ec
    assert rec.applied_immediately and rec.changed
    assert {r.segment_index for r in rec.reports} == set(host_idx)
    segs = s.ec.segments()
    for i_seg in host_idx:
        for li in range(segs[i_seg].start, segs[i_seg].stop):
            assert engine.config.layer_configs[li] != CPU
    assert rec.new_expected_s <= rec.old_expected_s
    assert engine.config.proper_batch_size == s.ec.proper_batch_size
    assert ctl.telemetry.stats() == {} and ctl.table is not s.table
    d = rec.to_dict()
    assert d["changed"] and d["reports"][0]["segment_index"] in host_idx


def test_controller_respects_max_remaps():
    results = []
    for ctl in _controllers(max_remaps=1):
        cfg = ctl.engine.config
        observe_segments(ctl.telemetry, cfg,
                         {i: 50.0 for i in range(len(cfg.segments()))})
        first = ctl.maybe_remap()
        cfg = ctl.engine.config
        observe_segments(ctl.telemetry, cfg,
                         {i: 50.0 for i in range(len(cfg.segments()))})
        assert ctl.maybe_remap() is None      # budget exhausted
        assert ctl.engine.swaps == 1
        results.append(first.to_dict())
    assert results[0] == results[1]


def test_controller_requires_telemetry():
    s = _small()
    with pytest.raises(ValueError, match="telemetry"):
        T_A.RemapController(_engine(), s.table)


def test_controller_serves_bit_exact_across_live_remap():
    """End to end through the controller: drift appears mid-stream and
    answers stay bit-exact throughout.  The engine samples real wall
    times (warmup 0), so the synthetic drift window is fed *after* the
    step's own real observation: the detector's recent floor (min of
    the last 3 samples) then covers synthetic samples only, and no
    real sample can decide the verdict.  (Fed before the step, as the
    JAX package's version of this test does, one real sample below
    1.5x the 1e-4 s/layer prediction cancels the injected drift, so
    the outcome follows the host's speed.)  The same scenario on the
    JAX package journals an equal record, telemetry aside."""
    s = _small()
    ins = _inputs(3, seed0=7)
    records = []
    for ctl in _controllers():
        port = isinstance(ctl, T_A.RemapController)
        for step_i, (xw, want) in enumerate(ins):
            reqs = [ctl.engine.submit(xw[j]) for j in range(BATCH)]
            if step_i == 1:
                assert ctl.engine.step(force=True) == BATCH
                observe_segments(ctl.telemetry, ctl.engine.config, {0: 50.0})
                assert ctl.maybe_remap() is not None
            else:
                assert ctl.step(force=True) == BATCH
            for j, r in enumerate(reqs):
                assert np.array_equal(np.asarray(r.wait(timeout=30)), want[j])
        assert ctl.engine.swaps == 1 and len(ctl.journal) == 1
        rec = ctl.journal[0]
        assert rec.at_step == 2 and rec.changed
        assert [r.segment_index for r in rec.reports] == [0]
        if port:
            assert ctl.engine.config.layer_configs != s.ec.layer_configs
        records.append({k: v for k, v in rec.to_dict().items()
                        if k != "telemetry"})
    assert records[0] == records[1]


def test_tenant_id_namespaces_journal_and_snapshot():
    s = _small()
    host_idx = [i for i, g in enumerate(s.ec.segments()) if not g.on_device]
    records = []
    for name in ("tenant-a", "tenant-b"):
        pair = []
        for pkg, make, table in ((R_A, _r_engine, s.r_table),
                                 (T_A, _engine, s.table)):
            tel = pkg.SegmentTelemetry(warmup=0, tenant=name)
            ctl = pkg.RemapController(
                make(telemetry=tel), table, clock=FakeClock(),
                detector=pkg.DriftDetector(rel_threshold=0.5, min_samples=3))
            assert ctl.tenant == name
            observe_segments(tel, ctl.engine.config,
                             {i: 50.0 for i in host_idx})
            assert tel.snapshot()["tenant"] == name
            pair.append(ctl.maybe_remap().to_dict())
        assert pair[0] == pair[1]
        records.append(pair[1])
    assert [r["tenant"] for r in records] == ["tenant-a", "tenant-b"]
    engine = _engine(telemetry=T_A.SegmentTelemetry(tenant="from-tel"))
    assert T_A.RemapController(engine, s.table, tenant="explicit",
                               clock=FakeClock()).tenant == "explicit"
    assert "tenant" not in T_A.SegmentTelemetry().snapshot()


# ---------------------------------------------------------------------------
# registry-wired hillclimb: the same mapping and trajectory
# ---------------------------------------------------------------------------


def _ref_hillclimb():
    """The JAX package's hillclimb; its module sets ``XLA_FLAGS`` when
    imported, which must not leak into later tests of this process."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.hillclimb import bnn_mapping_hillclimb as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def _variable_space_rows():
    rows = [
        {"CPU": 5e-4, "X": 4e-4, "XYZ": 3e-4},
        {"CPU": 5e-4, "XYZ": 4e-4, "xla_fused": 1e-4},
        {"CPU": 2e-4, "X": 4e-4, "XYZ": 4e-4, "pallas_p64n64": 3e-4},
    ]
    return ("synthetic", (1,), ("L1:C64", "L2:C64", "L3:FC128")), dict(
        times={1: rows}, kernel_times={1: [dict(r) for r in rows]},
        h2d_times={1: [1e-5] * 3}, d2h_times={1: [1e-5] * 3})


def test_hillclimb_searches_registry_candidate_sets():
    """The JAX package's variable-space table, with its two registered
    variant names registered in the port too (as device GEMM variants)
    for the length of the test."""
    args, kw = _variable_space_rows()
    added = []
    try:
        for name in ("xla_fused", "pallas_p64n64"):
            added.append(T_REG.register(T_REG.KernelVariant(
                name=name, builder=lambda a, w, k: None)))
        table = ProfileTable(*args, **kw)
        ec, trajectory = bnn_mapping_hillclimb(table)
        ec_dp = T_MAP.map_efficient_configuration(table, policy="dp")
        r_ec, r_traj = _ref_hillclimb()(R_Table(*args, **kw))
    finally:
        for v in added:
            T_REG.DEFAULT_REGISTRY.remove(v.name)
    assert ec.layer_configs == r_ec.layer_configs and trajectory == r_traj
    assert json.loads(ec.to_json()) == json.loads(r_ec.to_json())
    assert ec_dp.expected_time_per_example <= (
        ec.expected_time_per_example + 1e-15)
    assert ec.expected_time_per_example <= trajectory[0] + 1e-15
    assert trajectory == sorted(trajectory, reverse=True)
    assert ec.layer_configs[1] == "xla_fused"


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_hillclimb_never_worse_than_seed_and_dp_is_lower_bound(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 6))
    batches = (1, 2)
    times, kernels, h2d, d2h = {}, {}, {}, {}
    for b in batches:
        times[b], kernels[b], h2d[b], d2h[b] = [], [], [], []
        for _ in range(n):
            krow = {c: float(rng.uniform(1e-6, 1e-3)) for c in CONFIGS}
            up, down = rng.uniform(1e-6, 5e-4, 2)
            kernels[b].append(krow)
            times[b].append({c: krow[c] if c == CPU else krow[c] + up + down
                             for c in CONFIGS})
            h2d[b].append(float(up))
            d2h[b].append(float(down))
    args = ("synthetic", batches, tuple(f"L{i+1}:C8" for i in range(n)))
    kw = dict(times=times, kernel_times=kernels, h2d_times=h2d,
              d2h_times=d2h)
    table = ProfileTable(*args, **kw)
    ec, trajectory = bnn_mapping_hillclimb(table)
    r_ec, r_traj = _ref_hillclimb()(R_Table(*args, **kw))
    assert ec.layer_configs == r_ec.layer_configs and trajectory == r_traj
    ec_dp = T_MAP.map_efficient_configuration(table, policy="dp")
    assert ec.expected_time_per_example <= trajectory[0] + 1e-15
    assert ec_dp.expected_time_per_example <= (
        ec.expected_time_per_example + 1e-12)
