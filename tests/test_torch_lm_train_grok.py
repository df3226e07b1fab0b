"""LM training on the port against the JAX package on the CPU in f32:
grok-1's smoke config (8 experts top-2, no shared expert), loss and
every gradient leaf through the router and the capacity dispatch, then
two AdamW steps (deepseek-moe-16b is in ``test_torch_lm_train_moe.py``;
tolerances in ``tests/_torch_lm_train.py``)."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_lm_train as H  # noqa: E402


@pytest.fixture(scope="module")
def ref():
    return H.jax_reference("grok_1_314b")


def test_loss_and_grads_match_jax(ref):
    H.check_loss_and_grads(ref)


def test_two_adamw_steps_match_jax(ref):
    H.check_train_steps(ref)


def test_aux_loss_enters_the_loss_with_its_weight(ref):
    from repro_torch.models.steps import MOE_AUX_WEIGHT

    loss, ce, aux = ref["steps"][0]["loss_parts"]
    assert aux > 0
    assert loss == pytest.approx(ce + MOE_AUX_WEIGHT * aux, rel=1e-6)
