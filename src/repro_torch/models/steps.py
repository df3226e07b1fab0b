"""Serving step functions — the counterpart of ``repro.models.steps``:
``make_prefill_step``, ``make_serve_step`` and ``greedy_decode``.  The
train step waits for the optimizer port."""

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
    One new token against a pre-filled KV cache, which it updates in
    place."""

    def serve(params, cache, token):
        logits, new_cache, _ = forward(cfg, params, token, cache=cache)
        return logits[:, -1, :], new_cache

    return serve


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
    B, S = prompt.shape
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompt)
    # move prefill kv into a max_len cache
    full = init_cache(cfg, B, max_len, device=dev)
    for k in ("k", "v"):
        full[k][:, :, :S] = cache[k].to(full[k].dtype)
    full["len"] = cache["len"]
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
