"""LM training on the port (``repro_torch.models.steps.loss_fn`` and
``make_train_step``) against the JAX package on the CPU in f32: the
port of ``tests/test_arch_smoke.py``'s train step for the dense
attention archs qwen2-0.5B and OLMo-1B (minitron-8b and qwen2.5-14b
are in ``test_torch_lm_train_dense.py``), loss and every gradient leaf,
then two AdamW steps;
``accum_steps=2`` with ``grad_compression="bf16"`` on qwen2, over a
batch of 3 rows (the third is dropped, as the reference drops it).
The MoE, SSM, hybrid and front-end archs are in the other
``test_torch_lm_train_*.py`` files (one or two archs a file: the JAX
reference compiles two jitted steps per arch); the tolerances are in
``tests/_torch_lm_train.py``."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_lm_train as H  # noqa: E402

ARCHS = ("qwen2_0_5b", "olmo_1b")


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return H.jax_reference(request.param)


def test_loss_and_grads_match_jax(ref):
    H.check_loss_and_grads(ref)


def test_two_adamw_steps_match_jax(ref):
    H.check_train_steps(ref)


def test_accumulated_bf16_compressed_step_matches_jax():
    H.check_train_steps(H.jax_reference(
        "qwen2_0_5b", batch=3, n_steps=1, accum_steps=2,
        grad_compression="bf16"))


def test_make_train_step_refuses_an_unknown_compression():
    from repro_torch import configs as T_C
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import adamw

    with pytest.raises(ValueError, match="grad_compression"):
        make_train_step(T_C.get_smoke("qwen2_0_5b"), adamw(1e-3),
                        grad_compression="int8")
