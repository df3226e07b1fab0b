"""Step functions — the counterpart of ``repro.models.steps``:
``loss_fn`` and ``make_train_step`` for training, ``make_prefill_step``,
``make_serve_step``, ``decode_cache`` and ``greedy_decode`` for serving.

The train step differentiates the dict-tree params with
``torch.autograd.grad`` over their leaves (no ``nn.Parameter``), as
``jax.value_and_grad`` does; attention's gradient comes from
``kernels.flash_attention.FlashAttentionFn``.  One card, no mesh: the
reference's gradient all-reduce is implicit in its shardings, so
``grad_compression="bf16"`` is the same round trip through bfloat16
here, with nothing between the two casts.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import forward, init_cache
from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.tree import flatten, tree_map, unflatten

MOE_AUX_WEIGHT = 0.01


def loss_fn(
    cfg: ModelConfig,
    params: Any,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    frontend_embeds: Optional[torch.Tensor] = None,
    *,
    attention: Optional[Callable] = None,
):
    """Mean next-token cross-entropy (+ MoE aux), as ``(loss, (ce,
    aux))``.  When frontend embeds are prepended, the loss covers only
    the token region.  ``attention`` is the prefill attention
    (``transformer.attn_full``; ``chip_smoke.py`` passes the plain one
    to hold the kernel's path against it)."""
    logits, _, aux = forward(cfg, params, tokens,
                             frontend_embeds=frontend_embeds,
                             attention=attention)
    if frontend_embeds is not None:
        logits = logits[:, frontend_embeds.shape[1]:, :]
    # shift: predict token t+1 from position t
    lg = logits[:, :-1, :]
    lb = labels[:, 1:].long()
    lse = torch.logsumexp(lg, dim=-1)
    # the label's logit by a masked sum over the vocab, as the reference
    # picks it
    vocab_iota = torch.arange(lg.shape[-1], device=lg.device)[None, None, :]
    picked = torch.sum(torch.where(vocab_iota == lb[..., None], lg, 0.0),
                       dim=-1)
    ce = torch.mean(lse - picked)
    return ce + MOE_AUX_WEIGHT * aux, (ce, aux)


def make_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    *,
    accum_steps: int = 1,
    grad_compression: str = "none",   # none | bf16
    clip_norm: float = 1.0,
) -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics). batch = {'tokens', 'labels'[, 'frontend_embeds']}; metrics
    are 0-d float32 tensors ``loss``, ``ce``, ``moe_aux`` and
    ``grad_norm``.

    ``accum_steps > 1`` takes ``B // accum_steps`` rows per micro-step
    (remainder rows are dropped, as ``dynamic_slice_in_dim`` drops them)
    and sums the micro-gradients into float32 before dividing, so the
    optimizer sees float32 gradients; with ``accum_steps == 1`` they
    keep the params' dtype, as in the reference."""
    if grad_compression not in ("none", "bf16"):
        raise ValueError(f"grad_compression {grad_compression!r}: none or "
                         "bf16")

    def grads_of(params, tokens, labels, fe):
        flat, tdef = flatten(params)
        live = [t.detach().requires_grad_() for t in flat]
        loss, (ce, aux) = loss_fn(cfg, unflatten(tdef, live), tokens,
                                  labels, fe)
        got = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(live, got)]
        return (loss.detach(), ce.detach(), aux.detach(),
                unflatten(tdef, grads))

    def step(params, opt_state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        fe = batch.get("frontend_embeds")

        if accum_steps > 1:
            mb = tokens.shape[0] // accum_steps
            gsum = tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            lsum = torch.zeros(3, dtype=torch.float32, device=tokens.device)
            for i in range(accum_steps):
                rows = slice(i * mb, (i + 1) * mb)
                loss, ce, aux, g = grads_of(
                    params, tokens[rows], labels[rows],
                    None if fe is None else fe[rows])
                gsum = tree_map(torch.add, gsum, g)
                lsum = lsum + torch.stack([loss, ce, aux])
            grads = tree_map(lambda g: g / accum_steps, gsum)
            loss, ce, aux = lsum / accum_steps
        else:
            loss, ce, aux, grads = grads_of(params, tokens, labels, fe)

        if grad_compression == "bf16":
            grads = tree_map(
                lambda g: g.to(torch.bfloat16).to(torch.float32), grads)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        return new_params, new_opt, {
            "loss": loss, "ce": ce, "moe_aux": aux, "grad_norm": gnorm,
        }

    return step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """fn(params, tokens[, frontend_embeds]) -> (last_logits, cache)."""

    def prefill(params, tokens, frontend_embeds=None):
        logits, cache, _ = forward(
            cfg, params, tokens,
            frontend_embeds=frontend_embeds, return_cache=True,
            last_only=True,
        )
        return logits[:, -1, :], cache

    return prefill


def make_serve_step(cfg: ModelConfig) -> Callable:
    """fn(params, cache, token (B,1)) -> (logits (B,V), new_cache).
    One new token against a pre-filled KV/SSM cache, which it updates
    in place."""

    def serve(params, cache, token):
        logits, new_cache, _ = forward(cfg, params, token, cache=cache)
        return logits[:, -1, :], new_cache

    return serve


def decode_cache(cfg: ModelConfig, prefill_cache: dict, max_len: int, *,
                 device=None) -> dict:
    """A ``max_len`` decode cache on ``device`` (``None`` -> ``cuda``)
    seeded from a prefill's cache, as the JAX package's
    ``greedy_decode`` seeds it: the kv into its first S positions, the
    SSM conv rings and states whole."""
    dev = resolve_device(device)
    S = prefill_cache["len"]
    batch = prefill_cache["ssd" if "ssd" in prefill_cache else "k"].shape[1]
    full = init_cache(cfg, batch, max_len, device=dev)
    for k in ("k", "v"):
        if k in full:
            full[k][:, :, :S] = prefill_cache[k].to(full[k].dtype)
    for k in ("conv_x", "conv_bc", "ssd"):
        if k in full:
            full[k] = prefill_cache[k].to(full[k].dtype)
    full["len"] = S
    return full


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def greedy_decode(
    cfg: ModelConfig, params, prompt, n_steps: int, max_len: int, *,
    device=None, stats: Optional[dict] = None,
) -> torch.Tensor:
    """Autoregressive greedy loop: prefill ``prompt`` (B, S) ints, then
    ``n_steps - 1`` single-token decodes; returns the (B, n_steps) int64
    tokens.  Runs on ``device`` (``None`` -> ``cuda``), where ``params``
    must lie.  With ``stats`` (a dict), the device is synchronised at the
    phase boundaries and ``prefill_s``, ``decode_s`` and
    ``decode_steps`` are filled in."""
    dev = resolve_device(device)
    if params["embed"].device != dev:
        raise ValueError(f"params lie on {params['embed'].device}, "
                         f"decoding on {dev}")
    if isinstance(prompt, np.ndarray):
        prompt = torch.from_numpy(prompt)
    prompt = prompt.to(device=dev, dtype=torch.int64)
    prefill = make_prefill_step(cfg)
    serve = make_serve_step(cfg)
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompt)
    full = decode_cache(cfg, cache, max_len, device=dev)
    del cache

    toks = [logits.argmax(-1)[:, None]]
    if stats is not None:
        _sync(dev)
        t1 = time.perf_counter()
        stats["prefill_s"] = t1 - t0
    cache = full
    for _ in range(n_steps - 1):
        logits, cache = serve(params, cache, toks[-1])
        toks.append(logits.argmax(-1)[:, None])
    out = torch.cat(toks, dim=1)
    if stats is not None:
        _sync(dev)
        stats["decode_s"] = time.perf_counter() - t1
        stats["decode_steps"] = n_steps - 1
    return out
