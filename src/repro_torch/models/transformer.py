"""Unified decoder: dense / MoE / SSM / hybrid / VLM / audio backbones —
the counterpart of ``repro.models.transformer``.

Parameters are a dict of stacked tensors with a leading L axis, as the
JAX package's ``_shape_tree`` lays them out; a Python loop over L takes
the place of ``lax.scan``.  Prefill attention is
``modules.chunked_attention`` (the hand-written flash kernel on CUDA
tensors); decode attention is the plain grouped einsum over the cache,
outside any kernel in the JAX package too.  With ``cfg.remat`` a train
forward checkpoints each attention and Mamba layer (``_remat``), where
the JAX package wraps its scanned layer body in ``jax.checkpoint``.
MoE blocks route through
``moe.moe_ffn``; the SSM family stacks ``mamba2.mamba_block``s, and the
hybrid (zamba2) family runs ``attn_every``-layer Mamba segments with a
weight-shared attention block after each.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import modules as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba2 import mamba_block
from repro_torch.models.moe import moe_ffn
from repro_torch.parallel.constrain import (
    attn_kv_parallel_enabled,
    constrain_kv,
    merge_dims,
    pin_batch,
    sp_residual_enabled,
    split_dim,
)
from repro_torch.tree import leaves

# {'k','v': (L,B,Smax,Hkv,hd), 'len': int}; ssm: {'conv_x','conv_bc':
# (L,B,K,C), 'ssd': (L,B,H,P,N) f32, 'len'}; hybrid: both, k/v stacked
# over the n_seg shared-block applications
Cache = dict


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


@contextlib.contextmanager
def _context_of(ctx: contextvars.Context):
    """Every context variable set to its value in ``ctx`` for the
    block."""
    tokens = [(var, var.set(value)) for var, value in ctx.items()]
    try:
        yield
    finally:
        for var, tok in reversed(tokens):
            var.reset(tok)


def _recompute_in_forward_context():
    # the autograd engine runs a CUDA backward on its own device thread,
    # which sees none of the caller's context variables: the recompute
    # gets the forward's ambient mesh and scheme (parallel.constrain)
    return contextlib.nullcontext(), _context_of(contextvars.copy_context())


def _remat(cfg: ModelConfig, fn: Callable, decode: bool) -> Callable:
    """``fn``, a layer body, under a non-reentrant
    ``torch.utils.checkpoint`` when ``cfg.remat`` asks for it, autograd
    records and the call is not a decode step: the backward recomputes
    the layer's forward from its inputs instead of keeping its
    intermediates, where the JAX package wraps the scanned body in
    ``jax.checkpoint``.  The recompute runs in the forward's context
    variables, and stops once the tensors the backward saved are rebuilt
    (a layer's last matmul is not rerun).  No layer draws random
    numbers, so the RNG state is not stashed (which also lets the dry
    run's fake CUDA tensors through on hosts without a card).  Otherwise
    ``fn`` itself, as for a layer with nothing to differentiate (a
    prefill with autograd on)."""
    if not (cfg.remat and torch.is_grad_enabled() and not decode):
        return fn

    def run(h, bp):
        if not (h.requires_grad or any(t.requires_grad for t in leaves(bp))):
            return fn(h, bp)
        return checkpoint(fn, h, bp, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=_recompute_in_forward_context)

    return run


def _pin_residual(x: torch.Tensor) -> torch.Tensor:
    """Pin the residual stream to (batch@data-axes, seq, d replicated);
    under sequence parallelism the seq dim shards over 'model'.  An
    identity without a mesh and on plain tensors
    (``parallel.constrain``)."""
    seq_ax = "model" if sp_residual_enabled() else None
    return pin_batch(x, seq_ax, None)


# ---------------------------------------------------------------------------
# Parameter shapes (the JAX package's layout)
# ---------------------------------------------------------------------------


def _attn_block_shapes(cfg: ModelConfig, prefix_l: tuple) -> dict:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sh = {
        "wq": prefix_l + (d, H * hd),
        "wk": prefix_l + (d, Hkv * hd),
        "wv": prefix_l + (d, Hkv * hd),
        "wo": prefix_l + (H * hd, d),
    }
    if cfg.qkv_bias:
        sh |= {
            "bq": prefix_l + (H * hd,),
            "bk": prefix_l + (Hkv * hd,),
            "bv": prefix_l + (Hkv * hd,),
        }
    return sh


def _mlp_shapes(cfg: ModelConfig, prefix_l: tuple, d_ff: int) -> dict:
    d = cfg.d_model
    if cfg.mlp_type == "silu":
        return {
            "wg": prefix_l + (d, d_ff),
            "wu": prefix_l + (d, d_ff),
            "wd": prefix_l + (d_ff, d),
        }
    return {"wu": prefix_l + (d, d_ff), "wd": prefix_l + (d_ff, d)}


def _mamba_shapes(cfg: ModelConfig, prefix_l: tuple) -> dict:
    """Projections kept separate (not fused), as the JAX package keeps
    them."""
    s = cfg.ssm
    d, din = cfg.d_model, cfg.d_inner
    gn = s.n_groups * s.d_state
    H = cfg.ssm_heads
    return {
        "in_z": prefix_l + (d, din),
        "in_x": prefix_l + (d, din),
        "in_bc": prefix_l + (d, 2 * gn),
        "in_dt": prefix_l + (d, H),
        "conv_x_w": prefix_l + (s.conv_kernel, din),
        "conv_x_b": prefix_l + (din,),
        "conv_bc_w": prefix_l + (s.conv_kernel, 2 * gn),
        "conv_bc_b": prefix_l + (2 * gn,),
        "A_log": prefix_l + (H,),
        "D": prefix_l + (H,),
        "dt_bias": prefix_l + (H,),
        "gnorm": prefix_l + (din,),
        "out_proj": prefix_l + (din, d),
    }


def _shape_tree(cfg: ModelConfig) -> dict:
    d, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    lp = (L,)
    tree: dict = {"embed": (V, d)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (d, V)
    if cfg.norm == "rms":
        tree["final_norm"] = (d,)

    if cfg.family in ("ssm", "hybrid"):
        blocks = {"mamba": _mamba_shapes(cfg, lp)}
        if cfg.norm == "rms":
            blocks["ln1"] = lp + (d,)
        tree["blocks"] = blocks
        if cfg.family == "hybrid":
            shared = {
                "attn": _attn_block_shapes(cfg, ()),
                "mlp": _mlp_shapes(cfg, (), cfg.d_ff),
            }
            if cfg.norm == "rms":
                shared["ln1"] = (d,)
                shared["ln2"] = (d,)
            tree["shared"] = shared
        return tree

    blocks: dict = {"attn": _attn_block_shapes(cfg, lp)}
    if cfg.norm == "rms":
        blocks["ln1"] = lp + (d,)
        blocks["ln2"] = lp + (d,)
    if cfg.moe:
        fe = cfg.moe.d_expert or cfg.d_ff
        E = cfg.moe.n_experts
        blocks["moe"] = {
            "router": lp + (d, E),
            "wg": lp + (E, d, fe),
            "wu": lp + (E, d, fe),
            "wd": lp + (E, fe, d),
        }
        if cfg.moe.n_shared:   # the shared experts fused into one MLP
            blocks["mlp"] = _mlp_shapes(cfg, lp, cfg.moe.n_shared * fe)
    else:
        blocks["mlp"] = _mlp_shapes(cfg, lp, cfg.d_ff)
    tree["blocks"] = blocks
    return tree


def param_specs(cfg: ModelConfig) -> dict:
    """The params' shapes and dtype as ``meta`` tensors (the port's
    ``jax.ShapeDtypeStruct``): nothing is allocated, grok-1's 314B
    included."""
    dt = _dtype(cfg)
    return _map_tree(lambda _, sh: torch.empty(sh, dtype=dt, device="meta"),
                     _shape_tree(cfg))


def _map_tree(fn: Callable, tree: dict, path: tuple = ()) -> dict:
    """fn(path, leaf) over a nested dict, keys in sorted order (JAX's)."""
    return {
        k: _map_tree(fn, tree[k], path + (k,)) if isinstance(tree[k], dict)
        else fn(path + (k,), tree[k])
        for k in sorted(tree)
    }


def init_params(
    cfg: ModelConfig, generator: torch.Generator, device=None
) -> dict:
    """Random initialization (smoke tests, examples, ``chip_smoke.py``)
    by the JAX package's recipe: scaled normal for matmuls, ones for
    norm scales (and the SSD's ``D``), zeros for QKV biases, and the
    Mamba2 reference's ``A_log`` = log U[1, 16) and ``dt_bias`` =
    softplus^-1 U[1e-3, 1e-1].  Draws on ``generator``'s device (pass a
    CUDA generator to draw on the card) and returns tensors of
    ``cfg.dtype`` on ``device`` (``None`` -> ``cuda``).  Leaves of three
    or more axes are drawn one slice of the leading axis at a time, so
    the f32 draw of a stacked leaf (deepseek-moe-16b's ``blocks/moe/wg``
    is 5.2 G elements) never exists whole beside the weights."""
    dev = resolve_device(device)
    dt = _dtype(cfg)

    def draw(sh, fn):
        out = torch.empty(sh, dtype=dt, device=dev)
        for row in (out if len(sh) >= 3 else out[None]):
            row.copy_(fn(row.shape))
        return out

    def uniform(sh, lo, hi):
        return torch.rand(sh, generator=generator, device=generator.device,
                          dtype=torch.float32) * (hi - lo) + lo

    def init_one(path, sh):
        name = path[-1]
        if name in ("ln1", "ln2", "final_norm", "gnorm", "D"):
            return torch.ones(sh, dtype=dt, device=dev)
        # the JAX package lists a "conv_b" here, which names no leaf: its
        # conv_x_b / conv_bc_b get the scaled-normal draw below, and so
        # do the port's
        if name in ("bq", "bk", "bv"):
            return torch.zeros(sh, dtype=dt, device=dev)
        if name == "A_log":    # A in [1, 16), the mamba2 reference's
            return torch.log(uniform(sh, 1.0, 16.0)).to(dev, dt)
        if name == "dt_bias":  # dt ~ U[1e-3, 1e-1] through softplus^-1
            return torch.log(torch.expm1(uniform(sh, 1e-3, 1e-1))).to(dev,
                                                                        dt)
        fan_in = sh[-2] if len(sh) >= 2 else sh[-1]
        return draw(sh, lambda shape: torch.randn(
            shape, generator=generator, device=generator.device,
            dtype=torch.float32).div_(math.sqrt(fan_in)))

    return _map_tree(init_one, _shape_tree(cfg))


def params_from_jax(cfg: ModelConfig, tree_of_numpy: dict,
                    device=None) -> dict:
    """The JAX package's params (a nested dict of NumPy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's tensors of
    ``cfg.dtype`` on ``device``.  Raises on a missing or extra leaf or a
    shape that differs from the config's."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    shapes = _shape_tree(cfg)

    def convert(path, sh):
        node = tree_of_numpy
        for key in path:
            if not isinstance(node, dict) or key not in node:
                raise ValueError(f"params: missing {'/'.join(path)}")
            node = node[key]
        arr = np.array(node, dtype=np.float32)   # a copy we own
        if arr.shape != sh:
            raise ValueError(f"params {'/'.join(path)}: shape {arr.shape}, "
                             f"config says {sh}")
        return torch.from_numpy(arr).to(device=dev, dtype=dt)

    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,)

    extra = set(leaves(tree_of_numpy)) - set(leaves(shapes))
    if extra:
        raise ValueError(f"params: leaves the config has not: {sorted(extra)}")
    return _map_tree(convert, shapes)


def params_to_numpy(params: dict) -> dict:
    """The reverse of :func:`params_from_jax`: NumPy arrays on the host,
    bf16 widened to float32 (NumPy has no bf16)."""
    def one(path, t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return _map_tree(one, params)


def _layers(tree: dict, n: int) -> list:
    """The n layers of a stacked block tree, each a dict of views, from
    one ``unbind`` per leaf: its backward stacks the layers' gradients
    once, where indexing layer by layer would add a full-size gradient
    per layer."""
    cols = {k: _layers(v, n) if isinstance(v, dict) else v.unbind(0)
            for k, v in tree.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _proj_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions):
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = split_dim(q, 2, H, hd)
    k = split_dim(k, 2, Hkv, hd)
    v = split_dim(v, 2, Hkv, hd)
    q = M.rope(q, positions, cfg.rope_theta)
    k = M.rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_full(cfg: ModelConfig, p: dict, x: torch.Tensor, positions, *,
              attention: Optional[Callable] = None):
    """Train / prefill attention. Returns (out, (k, v)).

    Under ``scheme_context`` of a scheme with ``attn_kv_parallel`` the
    attention is ``modules.chunked_attention_kv_parallel`` (kernel 3 once
    per KV part on CUDA tensors), as in the JAX package.  Otherwise
    ``attention``, which defaults to ``modules.chunked_attention`` (the
    flash kernel on CUDA tensors); ``chip_smoke.py`` passes
    ``modules.chunked_attention_plain`` to hold the kernel path against
    the plain one on the card.  The kv returned for the cache are
    ``constrain_kv``'d copies."""
    q, k, v = _proj_qkv(cfg, p, x, positions)
    if attn_kv_parallel_enabled():
        o = M.chunked_attention_kv_parallel(
            q, k, v, causal=True,
            q_chunk=cfg.attn_q_chunk, remat_chunks=cfg.remat,
        )
    else:
        o = (attention or M.chunked_attention)(
            q, k, v, causal=True,
            q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
            remat_chunks=cfg.remat,
        )
    out = merge_dims(o, 2) @ p["wo"]
    return out, (constrain_kv(k), constrain_kv(v))


def attn_decode(
    cfg: ModelConfig, p: dict, x: torch.Tensor,
    cache_k: torch.Tensor, cache_v: torch.Tensor, cache_len: int,
):
    """Single-token decode against a (B, Smax, Hkv, hd) cache.  Grouped
    einsum avoids materializing repeated KV heads.  The new token's k/v
    are written into the cache in place (the JAX step returns an updated
    copy), and the same tensors are returned."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = H // Hkv
    if not 0 <= cache_len < cache_k.shape[1]:
        raise ValueError(f"decode at position {cache_len} of a cache of "
                         f"{cache_k.shape[1]}")
    positions = torch.full((B, 1), cache_len, dtype=torch.int64,
                           device=x.device)
    q, k, v = _proj_qkv(cfg, p, x, positions)
    cache_k[:, cache_len] = k[:, 0].to(cache_k.dtype)
    cache_v[:, cache_len] = v[:, 0].to(cache_v.dtype)
    qg = split_dim(q[:, 0], 1, Hkv, g)             # (B,Hkv,g,hd)
    s = torch.einsum(
        "bkgd,bskd->bkgs", qg.float(), cache_k.float()
    ) * (hd ** -0.5)                              # (B,Hkv,g,Smax)
    kpos = torch.arange(cache_k.shape[1], device=x.device)
    s = torch.where(kpos <= cache_len, s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", w, cache_v.float()).to(x.dtype)
    out = o.reshape(B, 1, H * hd) @ p["wo"]
    return out, (cache_k, cache_v)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _mlp_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_type == "silu":
        return M.gated_mlp(x, p["wg"], p["wu"], p["wd"])
    if cfg.mlp_type == "relu2":
        return M.relu2_mlp(x, p["wu"], p["wd"])
    return M.gelu_mlp(x, p["wu"], p["wd"])


def attn_block_apply(
    cfg: ModelConfig, bp: dict, x: torch.Tensor, positions,
    *, cache: Optional[dict] = None, cache_len=None,
    attention: Optional[Callable] = None,
):
    """One attention block. Returns (x, kv_for_cache, aux_loss); the aux
    loss is MoE's load-balance term (0.0 for a dense MLP)."""
    x = _pin_residual(x)
    h = M.apply_norm(cfg.norm, x, bp.get("ln1"))
    if cache is None:
        a, kv = attn_full(cfg, bp["attn"], h, positions, attention=attention)
    else:
        a, kv = attn_decode(
            cfg, bp["attn"], h, cache["k"], cache["v"], cache_len
        )
    x = x + a
    h2 = M.apply_norm(cfg.norm, x, bp.get("ln2"))
    aux = 0.0
    if cfg.moe:
        # groups = batch rows, as the JAX package dispatches
        m, aux = moe_ffn(h2, bp["moe"], cfg)
        if cfg.moe.n_shared:
            m = m + _mlp_apply(cfg, bp["mlp"], h2)
    else:
        m = _mlp_apply(cfg, bp["mlp"], h2)
    return x + m, kv, aux


def mamba_block_apply(
    cfg: ModelConfig, bp: dict, x: torch.Tensor,
    *, cache: Optional[dict] = None,
):
    x = _pin_residual(x)
    h = M.apply_norm(cfg.norm, x, bp.get("ln1"))
    out, new_cache = mamba_block(cfg, h, bp["mamba"], cache=cache)
    return x + out, new_cache


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------


def _embed(cfg: ModelConfig, params, tokens, frontend_embeds):
    # F.embedding, not indexing: both gather the same rows, but only
    # embedding's backward sums repeated tokens in a fixed order on the
    # CPU (indexing's accumulating index_put_ does not), so a training
    # step gives the same bits run after run
    x = F.embedding(tokens.long(), params["embed"]).to(_dtype(cfg))
    if frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(_dtype(cfg)), x], dim=1)
    return x


def _unembed(cfg: ModelConfig, params, x):
    x = M.apply_norm(cfg.norm, x, params.get("final_norm"))
    head = (
        params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    )
    return (x @ head).float()


def forward(
    cfg: ModelConfig,
    params: Any,
    tokens: torch.Tensor,
    *,
    frontend_embeds: Optional[torch.Tensor] = None,
    cache: Optional[Cache] = None,
    return_cache: bool = False,
    last_only: bool = False,
    attention: Optional[Callable] = None,
):
    """Returns (logits, new_cache_or_None, moe_aux_loss), the aux loss a
    0-d f32 tensor summed over the MoE blocks (0 without any).

    cache=None             -> train / prefill over the full sequence
    cache + tokens (B,1)   -> single-token decode (updates the cache's
                              tensors in place and returns them)
    last_only=True         -> unembed only the final position (prefill:
                              avoids materializing (B,S,V) logits)
    attention              -> the prefill attention (see attn_full)
    """
    x = _pin_residual(_embed(cfg, params, tokens, frontend_embeds))
    B, S, _ = x.shape
    decode = cache is not None and S == 1
    positions = None if decode else (
        torch.arange(S, device=x.device)[None, :].expand(B, S))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        x, new_cache = _forward_ssm(cfg, params, x, cache, decode,
                                    return_cache)
    elif cfg.family == "hybrid":
        x, new_cache = _forward_hybrid(
            cfg, params, x, positions, cache, decode, return_cache,
            attention)
    else:
        x, new_cache, aux = _forward_attn(
            cfg, params, x, positions, cache, decode, return_cache,
            attention, aux)
    if last_only:
        x = x[:, -1:, :]
    logits = _unembed(cfg, params, x)
    if new_cache is not None:
        new_cache["len"] = (cache["len"] if decode else 0) + (
            1 if decode else S
        )
    if not (return_cache or decode):
        new_cache = None
    return logits, new_cache, aux


def _forward_attn(cfg, params, x, positions, cache, decode, return_cache,
                  attention, aux):
    blocks = _layers(params["blocks"], cfg.n_layers)
    if decode:
        for i in range(cfg.n_layers):
            x, _, a = attn_block_apply(
                cfg, blocks[i], x, None,
                cache={"k": cache["k"][i], "v": cache["v"][i]},
                cache_len=cache["len"],
            )
            aux = aux + a
        return x, {"k": cache["k"], "v": cache["v"]}, aux

    def body(h, bp):
        h, kv, a = attn_block_apply(cfg, bp, h, positions,
                                    attention=attention)
        return h, a, kv if return_cache else None

    body = _remat(cfg, body, decode)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, a, kv = body(x, blocks[i])
        aux = aux + a
        if return_cache:
            ks.append(kv[0])
            vs.append(kv[1])
    if not return_cache:
        return x, None, aux
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}, aux


_SSM_CACHE_KEYS = ("conv_x", "conv_bc", "ssd")


def _mamba_layers(cfg, blocks, x, layers, cache, decode, caches):
    """Mamba blocks ``layers`` of the stack (``blocks``: the per-layer
    list of :func:`_layers`).  Decode reads layer i's state from
    ``cache`` and writes the new one back in place; prefill appends each
    layer's handoff state to ``caches`` (a list) when it is not None.
    Each layer is a :func:`_remat` body, as the JAX package checkpoints
    its scanned Mamba layers."""
    body = _remat(cfg, lambda h, bp: mamba_block_apply(cfg, bp, h), decode)
    for i in layers:
        if decode:
            x, nc = mamba_block_apply(
                cfg, blocks[i], x,
                cache={k: cache[k][i] for k in _SSM_CACHE_KEYS})
            for k in _SSM_CACHE_KEYS:
                cache[k][i] = nc[k]
        else:
            x, nc = body(x, blocks[i])
            if caches is not None:
                caches.append(nc)
    return x


def _stack_states(caches: list) -> dict:
    return {k: torch.stack([c[k] for c in caches])
            for k in _SSM_CACHE_KEYS}


def _forward_ssm(cfg, params, x, cache, decode, return_cache):
    caches = [] if return_cache and not decode else None
    x = _mamba_layers(cfg, _layers(params["blocks"], cfg.n_layers), x,
                      range(cfg.n_layers), cache, decode, caches)
    if decode:
        return x, {k: cache[k] for k in _SSM_CACHE_KEYS}
    return x, None if caches is None else _stack_states(caches)


def _hybrid_split(cfg: ModelConfig):
    k = cfg.hybrid.attn_every
    n_seg = cfg.n_layers // k
    tail = cfg.n_layers - n_seg * k
    return k, n_seg, tail


def _forward_hybrid(cfg, params, x, positions, cache, decode, return_cache,
                    attention=None):
    """Mamba backbone; the weight-shared attention block runs after each
    k-layer segment (its KV cache is stacked over the n_seg segments),
    and the tail layers have no block after them.  The Mamba layers are
    :func:`_remat` bodies; the shared block is not, as in the JAX
    package."""
    k, n_seg, _ = _hybrid_split(cfg)
    blocks = _layers(params["blocks"], cfg.n_layers)
    shared = params["shared"]
    caches = [] if return_cache and not decode else None
    ks, vs = [], []
    for s in range(n_seg):
        x = _mamba_layers(cfg, blocks, x, range(s * k, (s + 1) * k), cache,
                          decode, caches)
        if decode:
            x, _, _ = attn_block_apply(
                cfg, shared, x, None,
                cache={"k": cache["k"][s], "v": cache["v"][s]},
                cache_len=cache["len"])
        else:
            x, (kk, vv), _ = attn_block_apply(cfg, shared, x, positions,
                                              attention=attention)
            if caches is not None:
                ks.append(kk)
                vs.append(vv)
    x = _mamba_layers(cfg, blocks, x, range(n_seg * k, cfg.n_layers), cache,
                      decode, caches)
    if decode:
        return x, {key: cache[key] for key in _SSM_CACHE_KEYS + ("k", "v")}
    if caches is None:
        return x, None
    new_cache = _stack_states(caches)
    new_cache["k"], new_cache["v"] = torch.stack(ks), torch.stack(vs)
    return x, new_cache


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def _cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    dt = _dtype(cfg)
    out: dict = {}
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        out["conv_x"] = (
            (cfg.n_layers, batch, s.conv_kernel, cfg.d_inner), dt)
        out["conv_bc"] = (
            (cfg.n_layers, batch, s.conv_kernel,
             2 * s.n_groups * s.d_state), dt)
        out["ssd"] = (
            (cfg.n_layers, batch, cfg.ssm_heads, s.head_dim, s.d_state),
            torch.float32)
    if cfg.family == "hybrid":
        _, n_seg, _ = _hybrid_split(cfg)
        out["k"] = ((n_seg, batch, max_len, cfg.n_kv_heads, cfg.hd), dt)
        out["v"] = out["k"]
    elif cfg.family != "ssm":
        out["k"] = ((cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd),
                    dt)
        out["v"] = out["k"]
    return out


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Cache:
    """The decode cache's shapes and dtypes as ``meta`` tensors, ``len``
    a 0-d int32 one; allocates nothing."""
    c: dict = {k: torch.empty(s, dtype=d, device="meta")
               for k, (s, d) in _cache_shapes(cfg, batch, max_len).items()}
    c["len"] = torch.empty((), dtype=torch.int32, device="meta")
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> Cache:
    """Zeroed decode cache on ``device`` (``None`` -> ``cuda``): KV for
    the attention families, conv rings and f32 SSD states for ssm, both
    for hybrid; ``len`` is a Python int."""
    dev = resolve_device(device)
    c: dict = {k: torch.zeros(s, dtype=d, device=dev)
               for k, (s, d) in _cache_shapes(cfg, batch, max_len).items()}
    c["len"] = 0
    return c
