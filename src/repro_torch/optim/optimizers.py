"""Functional optimizers over tensor trees, with an optax-like
(init, update) interface.

Each optimizer is a factory returning an :class:`Optimizer` of pure
functions, so states are plain trees (:mod:`repro_torch.tree`) that
checkpoint like any other tensor tree.  This mirrors the JAX package's
``repro.optim`` function for function, so their arithmetic can be held
equal; it is not ``torch.optim``.  Updates run under
``torch.no_grad()`` and return new tensors (nothing is updated in
place).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import flatten, leaves, tree_map, unflatten


class OptState(NamedTuple):
    step: torch.Tensor      # int32, 0-d, on the params' device
    inner: Any              # optimizer-specific tree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any], tuple[Any, OptState]]
    # update(grads, state, params) -> (new_params, new_state)


def _tree_zeros_like(tree, dtype=None):
    return tree_map(lambda p: torch.zeros_like(p, dtype=dtype or p.dtype),
                    tree)


def _zero_step(params) -> torch.Tensor:
    flat = leaves(params)
    device = flat[0].device if flat else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _sched(lr, step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(step)
    return torch.tensor(lr, dtype=torch.float32, device=step.device)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global L2 norm is at most `max_norm`, the
    norm before scaling).  The scaled leaves take JAX's type promotion
    of ``g * scale`` against the float32 scale: a bfloat16 gradient
    comes back float32, as the JAX package's does."""
    flat = leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in flat))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return tree_map(
        lambda g: g.to(torch.promote_types(g.dtype, scale.dtype)) * scale,
        grads), gnorm


def adamw(
    lr: float | Callable[[torch.Tensor], torch.Tensor],
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    state_dtype: torch.dtype = torch.float32,
) -> Optimizer:
    """AdamW.  ``state_dtype`` lets callers halve optimizer memory
    (bf16 m/v); the update itself runs in float32."""

    def init(params):
        return OptState(
            step=_zero_step(params),
            inner={
                "m": _tree_zeros_like(params, state_dtype),
                "v": _tree_zeros_like(params, state_dtype),
            },
        )

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        lr_t = _sched(lr, step)
        t = step.float()
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t

        def upd(g, m, v, p):
            g32 = g.float()
            m32 = m.float() * b1 + (1 - b1) * g32
            v32 = v.float() * b2 + (1 - b2) * torch.square(g32)
            mhat = m32 / bc1
            vhat = v32 / bc2
            delta = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.float()
            newp = p.float() - lr_t * delta
            return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

        flat_p, tdef = flatten(params)
        out = [upd(g, m, v, p) for g, m, v, p in zip(
            leaves(grads), leaves(state.inner["m"]), leaves(state.inner["v"]),
            flat_p)]
        new_p = unflatten(tdef, [o[0] for o in out])
        new_m = unflatten(tdef, [o[1] for o in out])
        new_v = unflatten(tdef, [o[2] for o in out])
        return new_p, OptState(step=step, inner={"m": new_m, "v": new_v})

    return Optimizer(init, update)


def sgd(
    lr: float | Callable[[torch.Tensor], torch.Tensor],
    *,
    momentum: float = 0.0,
    nesterov: bool = False,
) -> Optimizer:
    def init(params):
        inner = _tree_zeros_like(params) if momentum else None
        return OptState(step=_zero_step(params), inner=inner)

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        lr_t = _sched(lr, step)
        if momentum:
            new_mom = tree_map(lambda b, g: momentum * b + g, state.inner,
                               grads)
            eff = (
                tree_map(lambda g, b: g + momentum * b, grads, new_mom)
                if nesterov
                else new_mom
            )
        else:
            new_mom, eff = None, grads
        new_p = tree_map(lambda p, g: p - lr_t * g, params, eff)
        return new_p, OptState(step=step, inner=new_mom)

    return Optimizer(init, update)


def lion(
    lr: float | Callable[[torch.Tensor], torch.Tensor],
    *,
    b1: float = 0.9,
    b2: float = 0.99,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Lion — sign-based update; optimizer state is a single momentum
    tree (half of Adam's)."""

    def init(params):
        return OptState(step=_zero_step(params),
                        inner=_tree_zeros_like(params))

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        lr_t = _sched(lr, step)

        def upd(g, m, p):
            c = b1 * m + (1 - b1) * g
            newp = p - lr_t * (torch.sign(c) + weight_decay * p)
            newm = b2 * m + (1 - b2) * g
            return newp.to(p.dtype), newm

        flat_p, tdef = flatten(params)
        out = [upd(g, m, p) for g, m, p in zip(
            leaves(grads), leaves(state.inner), flat_p)]
        return (
            unflatten(tdef, [o[0] for o in out]),
            OptState(step=step, inner=unflatten(tdef, [o[1] for o in out])),
        )

    return Optimizer(init, update)
