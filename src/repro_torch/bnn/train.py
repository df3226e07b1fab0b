"""STE training for the paper's BNN models.

Latent fp32 weights, binarized on the forward pass (clipped STE
backward), fp batch-norm with running stats, AdamW on the latent
weights with post-update clipping of every trainable leaf to [-1, 1]
(the standard BNN recipe: it keeps latent weights in the STE's
pass-through region).  The JAX package's ``repro.bnn.train``, step for
step; ``train_state_from_numpy`` carries one of its states across.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.bnn import layers as L
from repro_torch.bnn.models import BNNModel, fp_params_from_numpy
from repro_torch.device import resolve_device
from repro_torch.optim import adamw, clip_by_global_norm
from repro_torch.optim.optimizers import OptState
from repro_torch.tree import flatten, from_numpy, leaves, tree_map, unflatten


class TrainState(NamedTuple):
    params: list  # full per-layer dicts (trainable + bn state)
    opt: OptState
    step: torch.Tensor


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.mean(lse - picked)


def init_train_state(model: BNNModel, generator: torch.Generator,
                     lr: float = 1e-3, device=None):
    """(TrainState on `device` (``None`` -> ``cuda``), its AdamW)."""
    dev = resolve_device(device)
    params = model.init(generator, dev)
    opt = adamw(lr)
    trainable, _ = L.split_trainable(params)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    return TrainState(params, opt.init(trainable), step), opt


def train_state_from_numpy(state_np, device=None) -> TrainState:
    """A JAX package ``TrainState`` (its params, AdamW ``m``/``v`` and
    steps, through ``np.asarray``) -> this package's on `device`
    (``None`` -> ``cuda``), every array's dtype kept."""
    dev = resolve_device(device)

    def put(a):
        return from_numpy(np.asarray(a), dev)

    opt = state_np.opt
    return TrainState(
        params=fp_params_from_numpy(state_np.params, dev),
        opt=OptState(step=put(opt.step), inner=tree_map(put, opt.inner)),
        step=put(state_np.step),
    )


def _fp32_convs():
    """cuDNN with TF32 off for the block, every other cuDNN setting as
    the caller left it (``cudnn.flags`` sets each one it is given)."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def train_step(model: BNNModel, opt, state: TrainState, x01, labels):
    """One STE step on the state's device.  Returns (new_state,
    metrics); the metrics are 0-d tensors (``loss``, ``acc``,
    ``grad_norm``).  `x01` and `labels` may be NumPy arrays."""
    dev = state.step.device
    x01 = torch.as_tensor(x01, dtype=torch.float32, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    trainable, bn_state = L.split_trainable(state.params)
    flat, tdef = flatten(trainable)
    live = [t.detach().requires_grad_(True) for t in flat]
    params = L.merge_params(unflatten(tdef, live), bn_state)
    # The forward convs multiply +-1 operands, exact in any format, but
    # cuDNN would also run the weight gradient in TF32 (a 10-bit
    # mantissa on grad_out); keep every conv in float32 so a step on the
    # card matches the same step on CPU tensors.  The fc matmuls follow
    # torch.backends.cuda.matmul.allow_tf32, False by default.
    with _fp32_convs():
        logits, new_params = model.apply_fp(params, x01, train=True)
        loss = cross_entropy(logits.float(), labels)
        grads = torch.autograd.grad(loss, live)
    with torch.no_grad():
        grads, gnorm = clip_by_global_norm(unflatten(tdef, list(grads)), 1.0)
        new_trainable, new_opt = opt.update(grads, state.opt, trainable)
        # clip latent weights (and gamma, beta) into the STE pass-through
        # region
        new_trainable = tree_map(lambda p: torch.clamp(p, -1.0, 1.0),
                                 new_trainable)
        _, new_bn = L.split_trainable(new_params)
        merged = L.merge_params(new_trainable, new_bn)
        acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return (
        TrainState(merged, new_opt, state.step + 1),
        {"loss": loss.detach(), "acc": acc, "grad_norm": gnorm},
    )


@torch.no_grad()
def eval_step(model: BNNModel, params, x01, labels) -> torch.Tensor:
    """Accuracy (0-d tensor) of the fp-sim eval forward on the params'
    device."""
    dev = leaves(params)[0].device
    x01 = torch.as_tensor(x01, dtype=torch.float32, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    logits, _ = model.apply_fp(params, x01, train=False)
    return torch.mean((torch.argmax(logits, -1) == labels).float())
