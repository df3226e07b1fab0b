"""Shared by ``tests/test_torch_lm_train*.py``: the JAX package's LM
train steps on one smoke config (built once per arch by each file's
module-scoped fixture; each file holds one or two archs, since the JAX
reference compiles two jitted functions per arch) and the checks that hold the port's
``loss_fn`` / ``make_train_step`` to them, on the CPU in f32.

Both packages start from the same parameters (JAX ``init_params(
PRNGKey(0))`` carried across with ``params_from_jax``) and take the
same NumPy batches.  Tolerances (f32, so only the order of sums
differs): loss, ce, aux and grad_norm within a relative 1e-5; each
gradient leaf within 1e-4 of its largest magnitude.  After AdamW
(``lr`` 1e-3) a parameter moves by about ``g / (|g| + 1e-8) x lr``,
which is within 1 % of +-lr wherever the clipped |g| is at least 1e-6:
there each parameter is held within 0.05 x lr; below it rounding
decides the step, and each parameter is held within 2 x lr per step."""

from __future__ import annotations

import numpy as np
import torch
import jax
import jax.numpy as jnp

from repro import configs as R_C
from repro import optim as R_optim
from repro.models import steps as R_S
from repro.models import transformer as R_T
from repro_torch import configs as T_C
from repro_torch import optim as T_optim
from repro_torch.models import steps as T_S
from repro_torch.models import transformer as T_T
from repro_torch.tree import flatten, leaves, paths, unflatten

REL_METRIC = 1e-5
REL_GRAD = 1e-4
LR = 1e-3
W_ATOL = 0.05        # x LR, where the clipped |g| >= GRAD_FLOOR
GRAD_FLOOR = 1e-6
SEQ = 16
METRICS = ("loss", "ce", "moe_aux", "grad_norm")


def make_batch(cfg, batch: int, seed: int) -> dict:
    """NumPy tokens (labels = tokens) and, where the config prepends
    them, front-end embeds."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, SEQ), dtype=np.int32)
    out = {"tokens": toks, "labels": toks}
    if cfg.n_frontend_embeds:
        out["frontend_embeds"] = rng.standard_normal(
            (batch, cfg.n_frontend_embeds, cfg.d_model)).astype(np.float32)
    return out


def _np_leaves(tree) -> list:
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _jax_loss(cfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: R_S.loss_fn(cfg, p, b["tokens"], b["labels"],
                                 b.get("frontend_embeds")),
        has_aux=True))


def jax_reference(arch: str, *, batch: int = 2, n_steps: int = 2,
                  accum_steps: int = 1, grad_compression: str = "none"
                  ) -> dict:
    """The JAX package's steps from ``init_params(PRNGKey(0))``: for
    each step its batch, the gradient the step takes (the accumulated
    and compressed one where asked), the metrics and the params after
    it."""
    cfg = R_C.get_smoke(arch)
    params = R_T.init_params(cfg, jax.random.PRNGKey(0))
    opt = R_optim.adamw(LR)
    step = jax.jit(R_S.make_train_step(
        cfg, opt, accum_steps=accum_steps, grad_compression=grad_compression))
    grad = _jax_loss(cfg)
    out = {"arch": arch, "accum_steps": accum_steps,
           "grad_compression": grad_compression,
           "params0": jax.tree.map(np.asarray, params), "steps": []}
    state = opt.init(params)
    for i in range(n_steps):
        b = make_batch(cfg, batch, 10 + i)
        mb = batch // accum_steps
        gsum, lsum = None, np.zeros(3)
        for j in range(accum_steps):
            part = {k: jnp.asarray(v[j * mb:(j + 1) * mb])
                    for k, v in b.items()}
            (loss, (ce, aux)), g = grad(params, part)
            g = [np.asarray(x, np.float32) for x in jax.tree.leaves(g)]
            gsum = g if gsum is None else [a + c for a, c in zip(gsum, g)]
            lsum += [float(loss), float(ce), float(aux)]
        g = [a / accum_steps for a in gsum]
        if grad_compression == "bf16":
            g = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                 for a in g]
        params, state, m = step(params, state,
                                {k: jnp.asarray(v) for k, v in b.items()})
        out["steps"].append({
            "batch": b, "grads": g, "loss_parts": lsum / accum_steps,
            "metrics": {k: float(v) for k, v in m.items()},
            "params": _np_leaves(params),
        })
    return out


def port_params(ref: dict) -> dict:
    cfg = T_C.get_smoke(ref["arch"])
    return T_T.params_from_jax(cfg, ref["params0"], device="cpu")


def port_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def port_loss_and_grads(cfg, params, b: dict):
    """(loss, ce, aux, [gradient leaves]) of the port's ``loss_fn``."""
    flat, tdef = flatten(params)
    live = [t.detach().requires_grad_() for t in flat]
    tb = port_batch(b)
    loss, (ce, aux) = T_S.loss_fn(cfg, unflatten(tdef, live), tb["tokens"],
                                  tb["labels"], tb.get("frontend_embeds"))
    got = torch.autograd.grad(loss, live, allow_unused=True)
    return float(loss.detach()), float(ce.detach()), float(aux.detach()), [
        torch.zeros_like(t) if g is None else g for t, g in zip(live, got)]


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a)


def leaf_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.max(np.abs(b))
    return float(np.max(np.abs(a - b)) / scale) if scale else float(
        np.max(np.abs(a)))


def check_loss_and_grads(ref: dict) -> None:
    """The port's loss and gradient at the initial params against the
    reference's first step."""
    cfg = T_C.get_smoke(ref["arch"])
    params = port_params(ref)
    first = ref["steps"][0]
    loss, ce, aux, grads = port_loss_and_grads(cfg, params, first["batch"])
    for got, want in zip((loss, ce, aux), first["loss_parts"]):
        assert rel(got, want) <= REL_METRIC, (got, want)
    names = paths(params)
    assert len(grads) == len(first["grads"])
    for name, g, want in zip(names, grads, first["grads"]):
        assert tuple(g.shape) == want.shape, name
        assert leaf_rel(g.numpy(), want) <= REL_GRAD, (
            name, leaf_rel(g.numpy(), want))


def check_train_steps(ref: dict) -> None:
    """The port's ``make_train_step`` over the reference's batches: the
    metrics of every step and the params after each."""
    cfg = T_C.get_smoke(ref["arch"])
    params = port_params(ref)
    opt = T_optim.adamw(LR)
    step = T_S.make_train_step(cfg, opt, accum_steps=ref["accum_steps"],
                               grad_compression=ref["grad_compression"])
    state = opt.init(params)
    names = paths(params)
    firm = None
    for n, want in enumerate(ref["steps"], start=1):
        params, state, m = step(params, state, port_batch(want["batch"]))
        assert set(m) == set(METRICS)
        for k in METRICS:
            assert m[k].dtype == torch.float32 and m[k].dim() == 0, k
            assert rel(float(m[k]), want["metrics"][k]) <= REL_METRIC, (
                n, k, float(m[k]), want["metrics"][k])
        clip = min(1.0, 1.0 / (want["metrics"]["grad_norm"] + 1e-9))
        now = [np.abs(clip * g) >= GRAD_FLOOR for g in want["grads"]]
        firm = now if firm is None else [a & b for a, b in zip(firm, now)]
        for name, p, w, f in zip(names, leaves(params), want["params"],
                                 firm):
            d = np.abs(p.detach().float().numpy() - w)
            assert float(d[f].max(initial=0.0)) <= W_ATOL * LR, (n, name)
            assert float(d[~f].max(initial=0.0)) <= 2 * LR * n, (n, name)
