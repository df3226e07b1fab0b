"""LM training on the port against the JAX package on the CPU in f32:
the archs that prepend front-end embeds (llava-next-mistral-7b,
musicgen-medium smoke configs), whose loss covers only the token
region; loss and every gradient leaf (the embeds' region dropped before
the shift), then two AdamW steps.  And the launcher,
``repro_torch.launch.train.main`` on CPU tensors: a run, then a relaunch
that restores the latest checkpoint and ends in the uninterrupted run's
state.  Tolerances in ``tests/_torch_lm_train.py``."""

from __future__ import annotations

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_lm_train as H  # noqa: E402

from repro_torch.tree import leaves  # noqa: E402

ARCHS = ("llava_next_mistral_7b", "musicgen_medium")


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return H.jax_reference(request.param)


def test_loss_and_grads_match_jax(ref):
    assert "frontend_embeds" in ref["steps"][0]["batch"]
    H.check_loss_and_grads(ref)


def test_two_adamw_steps_match_jax(ref):
    H.check_train_steps(ref)


def test_loss_covers_only_the_token_region(ref):
    """The embeds' positions never enter the loss: ce is the mean
    cross-entropy over the S - 1 shifted token positions of the full
    forward's logits from the embeds' end on."""
    from repro_torch import configs as T_C
    from repro_torch.models.steps import loss_fn
    from repro_torch.models.transformer import forward

    cfg = T_C.get_smoke(ref["arch"])
    params = H.port_params(ref)
    b = H.port_batch(ref["steps"][0]["batch"])
    fe = b["frontend_embeds"]
    loss, (ce, _) = loss_fn(cfg, params, b["tokens"], b["labels"], fe)
    logits, _, _ = forward(cfg, params, b["tokens"], frontend_embeds=fe)
    lg = logits[:, fe.shape[1]:-1]
    want = torch.nn.functional.cross_entropy(
        lg.reshape(-1, lg.shape[-1]), b["labels"][:, 1:].reshape(-1).long())
    assert float(ce) == pytest.approx(float(want), rel=H.REL_METRIC)


def test_launch_train_resumes_to_the_uninterrupted_state(tmp_path):
    from repro_torch.launch import train

    def run(ckpt):
        return train.main(["--arch", "qwen2_0_5b", "--device", "cpu",
                           "--steps", "4", "--batch", "2", "--seq", "16",
                           "--save-every", "2", "--ckpt", str(ckpt)])

    first = run(tmp_path / "a")
    out = first["out"]
    assert out["final_step"] == 4 and len(out["metrics"]) == 4
    assert all(np.isfinite(r["loss"]) for r in out["metrics"])
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "step_2", "step_4"]
    # a relaunch after losing step 4 restores step 2 and replays 3 and 4
    shutil.rmtree(tmp_path / "a" / "step_4")
    again = run(tmp_path / "a")
    assert again["loop"].start_step == 2
    assert [r["loss"] for r in again["out"]["metrics"]] == [
        r["loss"] for r in out["metrics"]][2:]
    for a, b in zip(leaves(again["loop"].state),
                    leaves(first["loop"].state)):
        assert a.device.type == "cpu" and torch.equal(a, b)
