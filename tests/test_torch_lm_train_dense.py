"""LM training on the port against the JAX package on the CPU in f32:
the dense archs minitron-8b (squared-ReLU MLP) and qwen2.5-14b smoke
configs, loss and every gradient leaf, then two AdamW steps (the rest
of the dense family is in ``test_torch_lm_train.py``; tolerances in
``tests/_torch_lm_train.py``)."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_lm_train as H  # noqa: E402

ARCHS = ("minitron_8b", "qwen2_5_14b")


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return H.jax_reference(request.param)


def test_loss_and_grads_match_jax(ref):
    H.check_loss_and_grads(ref)


def test_two_adamw_steps_match_jax(ref):
    H.check_train_steps(ref)
