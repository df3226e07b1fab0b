"""The BNN examples of the port (``examples/torch_quickstart.py``,
``torch_serve_mapped.py``, ``torch_serve_fleet.py``) against the JAX
package, run on CPU tensors (``--device cpu``) at their CI sizes, each
loaded by path and run through ``main([...])`` in a temporary working
directory.  Each starts from the JAX package's random state: the
quickstart from its ``init_train_state(PRNGKey(0))`` carried across with
``train_state_from_numpy``, the servers from its ``pack_params`` of
``model.init(PRNGKey(0))``.  Also: every ``examples/torch_*.py`` refuses
to run without a card unless given ``--device cpu``, and the serving
examples go through ``repro_torch.api`` alone.

Tolerances: packed words, mapped outputs and served answers are integer
results, held ``np.array_equal``; the quickstart's training losses and
gradient norms sum in another order than the JAX package's, held to a
relative ``RTOL`` (``tests/test_torch_train.py``'s), its accuracies
equal.  From the sixth step on the gradient norm is held to
``LATE_GRAD_RTOL``: AdamW's normalised update turns f32-order
differences in near-zero gradients into latent differences of up to a
few hundredths of the learning rate (``test_torch_train.py`` allows
0.05 x lr), and the batch-norm scales and shifts, which are not
binarized, carry them into the next steps' forward; the measured
worst is 2.6e-5 at step 6, every other step within 1.1e-6."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.bnn import models as R_M  # noqa: E402
from repro.bnn import train as R_T  # noqa: E402
from repro.core.mapper import EfficientConfiguration as R_EC  # noqa: E402
from repro.data import ShardedBatcher as R_Batcher  # noqa: E402
from repro.data import make_image_dataset as R_images  # noqa: E402
from repro.store import fleet_scope as R_fleet_scope  # noqa: E402
from repro_torch.bnn import models as T_M  # noqa: E402
from repro_torch.bnn import train as T_T  # noqa: E402
from repro_torch.core.mapper import EfficientConfiguration  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "serve_mapped", "serve_fleet", "train_lm",
            "hep_shard_demo")
RTOL = 1e-5
LATE_GRAD_RTOL = 1e-4


def load(name: str):
    """``examples/torch_<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_packed(scale: float):
    """(JAX model, its packed params, the port's copy on CPU tensors)."""
    rm = R_M.build_model("fashion_mnist", scale=scale)
    r_packed = R_M.pack_params(rm.specs, rm.init(jax.random.PRNGKey(0)))
    np_packed = [jax.tree.map(np.asarray, p) for p in r_packed]
    return rm, r_packed, T_M.packed_params_from_numpy(np_packed, "cpu")


def _jax_forward(rm, r_packed, xw) -> np.ndarray:
    return np.asarray(R_M.forward_packed(rm.specs, r_packed,
                                         jnp.asarray(np.asarray(xw))))


@pytest.mark.parametrize("name", EXAMPLES)
def test_every_example_needs_a_card_unless_asked_for_the_cpu(
        name, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name).main([])


def test_serving_examples_go_through_the_api_facade():
    """The port's counterpart of ``tests/test_api.py``'s check of the
    JAX serving examples."""
    for name in ("torch_serve_mapped.py", "torch_serve_fleet.py"):
        text = (ROOT / "examples" / name).read_text()
        assert "repro_torch.core.profiler" not in text, name
        assert "repro_torch.fleet.scheduler" not in text, name
        assert "from repro_torch import api" in text, name


def test_quickstart_equals_the_jax_package(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    lr = 2e-3
    rm = R_M.build_model("fashion_mnist", scale=0.25)
    r_state, r_opt = R_T.init_train_state(rm, jax.random.PRNGKey(0), lr=lr)
    got = load("quickstart").main(
        ["--smoke", "--device", "cpu"],
        state=T_T.train_state_from_numpy(r_state, device="cpu"))

    # the JAX package's 10 steps on the same batches
    ds = R_images(0, 2048, rm.input_hw, rm.in_channels)
    bt = R_Batcher(n=2048, global_batch=64, seed=0)
    assert len(got["metrics"]) == 10
    for step, m in enumerate(got["metrics"]):
        x, y = bt.batch((ds.x, ds.y), step)
        r_state, r_m = R_T.train_step(rm, r_opt, r_state, x, y)
        assert m["loss"] == pytest.approx(float(r_m["loss"]), rel=RTOL)
        assert m["grad_norm"] == pytest.approx(
            float(r_m["grad_norm"]), rel=RTOL if step < 5 else LATE_GRAD_RTOL)
        assert m["acc"] == float(r_m["acc"])
    xe, ye = bt.batch((ds.x, ds.y), 9_999)
    assert got["eval_acc"] == float(R_T.eval_step(rm, r_state.params, xe, ye))

    # the packed words of the trained net equal the JAX package's
    r_packed = R_M.pack_params(rm.specs, r_state.params)
    assert len(got["packed"]) == len(r_packed)
    for t, r in zip(got["packed"], r_packed):
        assert set(t) == set(r)
        for k in t:
            assert np.array_equal(np.asarray(t[k]), np.asarray(r[k])), k

    # the mapped output and the 8 served answers: the JAX forward
    want = _jax_forward(rm, r_packed, got["xw"])
    assert got["out"].shape == want.shape
    assert np.array_equal(got["out"], want)
    assert np.array_equal(got["ref"], want)
    assert len(got["served"]) == 8
    assert all(np.array_equal(s, want[0]) for s in got["served"])
    assert got["t_dp"] <= got["t_greedy"] * (1 + 1e-9)
    assert got["launches"]["profile"] == {"xnor_gemm_cuda": 0,
                                          "segment_cuda": 0,
                                          "flash_attention_cuda": 0}


def test_serve_mapped_equals_the_jax_package(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    rm, r_packed, packed = _jax_packed(0.25)
    got = load("serve_mapped").main(
        ["--scale", "0.25", "--requests", "32", "--device", "cpu"],
        packed=packed)
    ds = R_images(7, 32, rm.input_hw, rm.in_channels)
    xw = R_M.prepare_input_packed(jnp.asarray(ds.x))
    want = np.asarray(R_M.forward_packed(rm.specs, r_packed, xw))
    assert got["scores"].shape == (32, 10)
    assert np.array_equal(got["scores"], want)
    assert got["stats"]["served"] == 32
    assert got["p50_us"] <= got["p99_us"]

    # the artifact, under the working directory's results/
    path = tmp_path / "results" / "torch_serve_mapped_config.json"
    assert path.is_file()
    assert not (tmp_path / "results" / "efficient_config_fmnist.json").exists()
    text = path.read_text()
    assert EfficientConfiguration.from_json(text) == got["ec"]
    back = R_EC.from_json(text)     # the JAX package reads it too
    assert back.layer_configs == got["ec"].layer_configs
    assert back.proper_batch_size == got["ec"].proper_batch_size


def test_serve_fleet_equals_the_jax_package(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    jax_side = {"narrow": _jax_packed(0.25), "wide": _jax_packed(0.375)}
    got = load("serve_fleet").main(
        ["--smoke", "--device", "cpu"],
        packed={k: v[2] for k, v in jax_side.items()})
    assert got["store"].scope == R_fleet_scope(("narrow", "wide"))
    plan = got["plan"]
    assert plan.joint_makespan_s <= plan.baseline_makespan_s
    for name, (rm, r_packed, _) in jax_side.items():
        want = _jax_forward(rm, r_packed, got["inputs"][name])
        assert np.array_equal(got["refs"][name], want)
        answers = got["answers"][name]
        assert len(answers) + got["shed"][name] == 32
        for j, scores in answers:
            assert np.array_equal(scores, want[j]), (name, j)
        s = got["stats"]["tenants"][name]
        assert s["rejected"] == got["shed"][name]
        assert s["served"] == len(answers)
