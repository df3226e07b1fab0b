"""The LM examples of the port (``examples/torch_train_lm.py``,
``torch_hep_shard_demo.py``) against the JAX package, on CPU tensors
(``--device cpu``), each loaded by path and run through ``main([...])``
in a temporary working directory.

* train_lm on the smoke qwen2-0.5B config from the JAX package's
  ``init_params(PRNGKey(0))`` (carried across with ``params_from_jax``):
  each step's loss and grad_norm against the JAX ``make_train_step`` +
  ``adamw(linear_warmup_cosine(3e-3, 10, steps))`` on the same tokens
  (the port's token stream, which the example draws; the two packages'
  streams differ by design); a second run on the same ``--ckpt``
  resumes at the saved step.
* hep_shard_demo on the smoke olmo-1b config at a small train cell, its
  trials traced on ``fake_process_group(8)`` with a CPU mesh: the scheme
  it returns is one of the knob lattice, and both packages' ``search``
  fed the trial table it measured return the same best scheme and the
  same history, in order.

Tolerances (``tests/_torch_lm_train.py``'s, f32): loss within a relative
``REL_METRIC`` 1e-5, grad_norm within ``REL_GRAD`` 1e-4."""

from __future__ import annotations

import dataclasses
import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _torch_lm_train import REL_GRAD, REL_METRIC  # noqa: E402
from repro import configs as R_C  # noqa: E402
from repro import optim as R_optim  # noqa: E402
from repro.core import hep_shard as R_HS  # noqa: E402
from repro.models import steps as R_S  # noqa: E402
from repro.models import transformer as R_T  # noqa: E402
from repro_torch import configs as T_C  # noqa: E402
from repro_torch.core import hep_shard as T_HS  # noqa: E402
from repro_torch.data import make_token_stream  # noqa: E402
from repro_torch.models import transformer as T_T  # noqa: E402
from repro_torch.parallel.sharding import ShardScheme  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2_0_5b"
STEPS, BATCH, SEQ = 3, 8, 16


def load(name: str):
    """``examples/torch_<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def test_train_lm_steps_equal_the_jax_package_and_resume(monkeypatch,
                                                          tmp_path):
    monkeypatch.chdir(tmp_path)
    r_cfg = R_C.get_smoke(ARCH)
    r_params = R_T.init_params(r_cfg, jax.random.PRNGKey(0))
    cfg = T_C.get_smoke(ARCH)
    params = T_T.params_from_jax(cfg, jax.tree.map(np.asarray, r_params),
                                 device="cpu")
    argv = ["--device", "cpu", "--batch", str(BATCH), "--seq", str(SEQ),
            "--ckpt", str(tmp_path / "ckpt")]
    got = load("train_lm").main([*argv, "--steps", str(STEPS)],
                                params=params)
    assert got["resumed"] == 0 and got["final_step"] == STEPS
    assert [m["step"] for m in got["metrics"]] == list(range(1, STEPS + 1))

    opt = R_optim.adamw(R_optim.linear_warmup_cosine(3e-3, 10, STEPS))
    step = jax.jit(R_S.make_train_step(r_cfg, opt))
    sample = make_token_stream(0, cfg.vocab)
    p, o = r_params, opt.init(r_params)
    for i, m in enumerate(got["metrics"]):
        toks = jnp.asarray(sample(i, BATCH, SEQ).numpy())
        p, o, want = step(p, o, {"tokens": toks, "labels": toks})
        assert _rel(m["loss"], float(want["loss"])) <= REL_METRIC, i
        assert _rel(m["grad_norm"], float(want["grad_norm"])) <= REL_GRAD, i
    assert got["last"]["loss"] == got["metrics"][-1]["loss"]

    # the same --ckpt: the next run starts at the saved step
    again = load("train_lm").main([*argv, "--steps", str(STEPS + 2)])
    assert again["resumed"] == STEPS
    assert [m["step"] for m in again["metrics"]] == [STEPS + 1, STEPS + 2]
    assert all(np.isfinite(m["loss"]) for m in again["metrics"])


def _knobs(scheme) -> tuple:
    return (scheme.tp, scheme.fsdp, scheme.batch_over_model)


def test_hep_shard_demo_on_a_fake_world_and_both_searches_agree(
        monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    demo = load("hep_shard_demo")
    got = demo.main(["--device", "cpu"], cfg=T_C.get_smoke("olmo_1b"),
                    shape=T_C.ShapeCell("demo", "train", 128, 8))
    lattice = set(itertools.product(*demo.KNOBS.values()))
    best = got["best"]
    assert _knobs(best.scheme) in lattice
    assert best.scheme == dataclasses.replace(
        ShardScheme(), **dict(zip(demo.KNOBS, _knobs(best.scheme))))
    assert got["history"][0].scheme == ShardScheme()
    assert best.cost == min(t.cost for t in got["trials"].values())
    for t in got["trials"].values():
        assert t.compute_s > 0 and t.memory_s > 0 and t.peak_bytes > 0
        assert t.h2d_s > t.d2h_s > 0
    assert any(t.collective_s > 0 for t in got["trials"].values())

    # both packages' search on the demo's trial table, the JAX package's
    # device memory (16 GiB) for both
    table = {_knobs(s): t for s, t in got["trials"].items()}

    def port_trial(scheme):
        return dataclasses.replace(table[_knobs(scheme)], scheme=scheme,
                                   hbm_bytes=R_HS.HBM_BYTES)

    def jax_trial(scheme):
        t = table[_knobs(scheme)]
        return R_HS.ShardTrial(
            scheme=scheme, compute_s=t.compute_s, memory_s=t.memory_s,
            collective_s=t.collective_s, peak_bytes=t.peak_bytes,
            h2d_s=t.h2d_s, d2h_s=t.d2h_s)

    t_best, t_hist = T_HS.search(port_trial, knobs=demo.KNOBS, max_rounds=2,
                                 log=None)
    r_best, r_hist = R_HS.search(jax_trial, knobs=demo.KNOBS, max_rounds=2,
                                 log=None)
    assert _knobs(t_best.scheme) == _knobs(r_best.scheme)
    assert t_best.cost == r_best.cost
    hist = [(_knobs(t.scheme), t.cost) for t in t_hist]
    assert hist == [(_knobs(t.scheme), t.cost) for t in r_hist]
    # the demo's own search (the H100's memory) took the same path
    assert [(_knobs(t.scheme), t.cost) for t in got["history"]] == hist
