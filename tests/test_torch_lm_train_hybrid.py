"""LM training on the port against the JAX package on the CPU in f32:
zamba2-7b's smoke config (Mamba2 segments with one weight-shared
attention block after each, whose gradient sums over its applications),
loss and every gradient leaf, then two AdamW steps (mamba2-130m and the
SSD's own gradient are in ``test_torch_lm_train_ssm.py``; tolerances in
``tests/_torch_lm_train.py``)."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_lm_train as H  # noqa: E402


@pytest.fixture(scope="module")
def ref():
    return H.jax_reference("zamba2_7b")


def test_loss_and_grads_match_jax(ref):
    H.check_loss_and_grads(ref)


def test_two_adamw_steps_match_jax(ref):
    H.check_train_steps(ref)
