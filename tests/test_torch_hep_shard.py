"""HEP-Shard (``repro_torch.core.hep_shard``) against the JAX package's
``repro.core.hep_shard``: the cases of ``tests/test_sharding.py``
(planted optimum, OOM penalty, transfer split, an all-failing knob) on
the port, and both ``search``es run on one pure ``evaluate``: the same
best scheme, the same history of ``(astuple(scheme), cost)`` and the
same log lines.  The port's device memory is the card's; the trials of
these tests carry the reference's 16 GiB as ``hbm_bytes``."""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import hep_shard as R_HS  # noqa: E402
from repro.parallel.sharding import ShardScheme as R_Scheme  # noqa: E402
from repro_torch.core import ShardTrial as CoreShardTrial  # noqa: E402
from repro_torch.core import hep_shard as T_HS  # noqa: E402
from repro_torch.parallel.sharding import ShardScheme as T_Scheme  # noqa: E402

HBM = R_HS.HBM_BYTES   # the reference's v5e figure, 16 GiB


def test_hep_shard_search_finds_planted_optimum():
    """Coordinate descent reaches the planted best scheme and never
    returns a worse-cost scheme than any it evaluated."""
    target = T_Scheme(tp=False, fsdp="zero3", batch_over_model=True)

    def evaluate(s):
        dist = ((s.tp != target.tp) + (s.fsdp != target.fsdp)
                + (s.batch_over_model != target.batch_over_model))
        return T_HS.ShardTrial(scheme=s, compute_s=0.1 + dist, memory_s=0.05,
                               collective_s=0.01 * dist, peak_bytes=2**30,
                               hbm_bytes=HBM)

    best, history = T_HS.search(
        evaluate, knobs={"tp": (True, False), "fsdp": ("zero1", "zero3"),
                         "batch_over_model": (False, True)},
        log=None)
    assert best.scheme.tp == target.tp
    assert best.scheme.fsdp == target.fsdp
    assert best.scheme.batch_over_model == target.batch_over_model
    assert best.cost == min(t.cost for t in history)
    assert all(t.hbm_bytes == HBM for t in history)


def test_hep_shard_oom_penalty_dominates():
    def evaluate(s):
        fits = s.fsdp == "zero3"
        return T_HS.ShardTrial(scheme=s, compute_s=1.0 if fits else 0.1,
                               memory_s=0.0, collective_s=0.0,
                               peak_bytes=2**30 if fits else 64 * 2**30,
                               hbm_bytes=HBM)

    best, _ = T_HS.search(evaluate, knobs={"fsdp": ("zero1", "zero3")},
                          log=None)
    assert best.scheme.fsdp == "zero3"   # fitting beats fast-but-OOM


def test_hep_shard_oom_penalty_follows_the_device_memory():
    """The same 64 GiB peak is an OOM on 16 GiB and fits in 80 GB."""
    t = T_HS.ShardTrial(scheme=T_Scheme(), compute_s=0.1, memory_s=0.0,
                        collective_s=0.0, peak_bytes=64 * 2**30)
    assert dataclasses.replace(t, hbm_bytes=HBM).cost > 1e6
    assert dataclasses.replace(t, hbm_bytes=80 * 10**9).cost == \
        pytest.approx(0.1)


def test_hep_shard_transfer_split_in_cost():
    t = T_HS.ShardTrial(scheme=T_Scheme(), compute_s=1.0, memory_s=0.5,
                        collective_s=0.1, peak_bytes=2**30, h2d_s=0.2,
                        d2h_s=0.05, hbm_bytes=HBM)
    assert t.kernel_s == pytest.approx(1.1)
    assert t.transfer_s == pytest.approx(0.25)
    assert t.cost == pytest.approx(1.35)

    def evaluate(s):
        heavy = s.fsdp == "zero1"   # faster kernel, much heavier staging
        return T_HS.ShardTrial(scheme=s, compute_s=0.1 if heavy else 0.12,
                               memory_s=0.0, collective_s=0.0,
                               peak_bytes=2**30, h2d_s=0.5 if heavy else 0.0,
                               hbm_bytes=HBM)

    best, _ = T_HS.search(evaluate, knobs={"fsdp": ("zero1", "zero3")},
                          log=None)
    assert best.scheme.fsdp == "zero3"


def test_hep_shard_all_failing_knob_skipped():
    def evaluate(s):
        if s.tp:
            raise RuntimeError("tp unsupported on this mesh")
        return T_HS.ShardTrial(scheme=s, compute_s=1.0, memory_s=0.0,
                               collective_s=0.0, peak_bytes=2**30,
                               hbm_bytes=HBM)

    best, _ = T_HS.search(evaluate, T_Scheme(tp=False),
                          knobs={"tp": (True,)}, log=None)
    assert best.scheme.tp is False


def test_shard_trial_without_a_device_memory_needs_a_card():
    t = T_HS.ShardTrial(scheme=T_Scheme(), compute_s=1.0, memory_s=0.0,
                        collective_s=0.0, peak_bytes=0)
    if torch.cuda.is_available():
        assert t.cost == 1.0 and t.hbm_bytes is None
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t.cost


def test_knobs_and_exports_equal_reference():
    assert T_HS.KNOBS == R_HS.KNOBS
    assert T_HS.OOM_PENALTY == R_HS.OOM_PENALTY
    assert CoreShardTrial is T_HS.ShardTrial
    r = [f.name for f in dataclasses.fields(R_HS.ShardTrial)]
    t = [f.name for f in dataclasses.fields(T_HS.ShardTrial)]
    assert t == r + ["hbm_bytes"]


def _cost_model(s) -> dict:
    """One pure cost surface, read by both packages' evaluate: a planted
    lattice with an OOM region, a failing combination and transfers."""
    if s.expert_mode == "ep" and s.fsdp == "none":
        raise ValueError("ep without fsdp")
    compute = (1.0 + 0.3 * s.tp + 0.2 * (s.fsdp == "zero3")
               - 0.25 * s.batch_over_model + 0.1 * s.seq_over_model
               - 0.15 * s.attn_kv_parallel + 0.05 * s.out_proj_contracting_2d
               + 0.02 * s.accum_steps)
    peak = 40 * 2**30 // s.accum_steps // (2 if s.fsdp == "zero3" else 1)
    return {"compute_s": compute, "memory_s": 0.6 + 0.1 * (s.fsdp == "none"),
            "collective_s": 0.05 * (s.fsdp != "none") + 0.1 * s.tp,
            "peak_bytes": peak, "h2d_s": 0.01 * (not s.batch_over_model),
            "d2h_s": 0.003}


@pytest.mark.parametrize("start", [None, {"tp": False, "accum_steps": 8},
                                   {"fsdp": "none", "expert_mode": "tp"}])
@pytest.mark.parametrize("rounds", [1, 3])
def test_search_equals_reference_on_one_evaluate(start, rounds):
    r_log, t_log = [], []

    def r_eval(s):
        return R_HS.ShardTrial(scheme=s, **_cost_model(s))

    def t_eval(s):
        return T_HS.ShardTrial(scheme=s, **_cost_model(s), hbm_bytes=HBM)

    r_best, r_hist = R_HS.search(
        r_eval, None if start is None else R_Scheme(**start),
        max_rounds=rounds, log=r_log.append)
    t_best, t_hist = T_HS.search(
        t_eval, None if start is None else T_Scheme(**start),
        max_rounds=rounds, log=t_log.append)
    assert dataclasses.astuple(t_best.scheme) == dataclasses.astuple(
        r_best.scheme)
    assert t_best.cost == r_best.cost
    assert [(dataclasses.astuple(t.scheme), t.cost) for t in t_hist] == [
        (dataclasses.astuple(t.scheme), t.cost) for t in r_hist]
    assert t_log == r_log
    assert any("round 0" in line for line in t_log)
    assert any("ep without fsdp" in line for line in t_log) == any(
        "ep without fsdp" in line for line in r_log)
