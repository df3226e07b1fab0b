"""Serving step functions — the counterpart of ``repro.models.steps``:
``make_prefill_step``, ``make_serve_step``, ``decode_cache`` and
``greedy_decode``.  The train step waits for the optimizer port."""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import forward, init_cache


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
