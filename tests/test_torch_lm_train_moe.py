"""LM training on the port against the JAX package on the CPU in f32:
the MoE arch deepseek-moe-16b (grok-1 is in
``test_torch_lm_train_grok.py``), whose gradient
runs back through the router, the grouped capacity dispatch (the
accumulating ``index_put_``, trash column included, against the
reference's ``.at[].add``) and the load-balance aux loss; loss and every
gradient leaf, then two AdamW steps, and deepseek's ``accum_steps=2``
step with ``grad_compression="bf16"``.  Tolerances in
``tests/_torch_lm_train.py``."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_lm_train as H  # noqa: E402


@pytest.fixture(scope="module")
def ref():
    return H.jax_reference("deepseek_moe_16b")


def test_loss_and_grads_match_jax(ref):
    H.check_loss_and_grads(ref)


def test_two_adamw_steps_match_jax(ref):
    H.check_train_steps(ref)


def test_aux_loss_enters_the_loss_with_its_weight(ref):
    from repro_torch.models.steps import MOE_AUX_WEIGHT

    loss, ce, aux = ref["steps"][0]["loss_parts"]
    assert aux > 0
    assert loss == pytest.approx(ce + MOE_AUX_WEIGHT * aux, rel=1e-6)


def test_accumulated_bf16_compressed_step_matches_jax():
    H.check_train_steps(H.jax_reference(
        "deepseek_moe_16b", batch=3, n_steps=1, accum_steps=2,
        grad_compression="bf16"))
