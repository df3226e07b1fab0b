"""Shared neural modules: norms, RoPE, chunked attention, MLPs — the
counterpart of ``repro.models.modules``.

Numerics policy: activations in cfg.dtype (bf16), norms and softmax in
f32, residual stream in bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import (
    FlashAttentionFn,
    flash_attention_plain,
)


def rms_norm(x: torch.Tensor, scale: torch.Tensor | None, eps: float = 1e-6):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if scale is not None:
        y = y * scale.float()
    return y.to(x.dtype)


def nonparam_layernorm(x: torch.Tensor, eps: float = 1e-5):
    """OLMo's non-parametric LayerNorm (no scale, no bias)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(kind: str, x: torch.Tensor, scale: torch.Tensor | None):
    if kind == "rms":
        return rms_norm(x, scale)
    if kind == "nonparam":
        return nonparam_layernorm(x)
    raise ValueError(kind)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x (..., S, H, D); positions (..., S) integer."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    # a Python-scalar base: a tensor made from it on the card would be a
    # host-to-device copy, which synchronises the stream on every call
    freqs = torch.pow(float(theta), exps)
    ang = positions.float()[..., None] * freqs            # (...,S,half)
    cos = torch.cos(ang)[..., None, :]                     # (...,S,1,half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.cat([xr1, xr2], dim=-1).to(x.dtype)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_chunk: int,
    kv_chunk: int,
    kv_offset: int = 0,
    remat_chunks: bool = True,
) -> torch.Tensor:
    """Blockwise-softmax (flash) attention, differentiable in q, k, v.

    q (B,Sq,H,D); k,v (B,Sk,Hkv,D). Causal uses suffix alignment:
    query i attends to keys j <= i + kv_offset (kv_offset = Sk - Sq for
    aligned prefill). Returns (B,Sq,H,D) in q.dtype.

    Runs through :class:`FlashAttentionFn` on (B,H,S,D) views of the
    operands.  On CUDA tensors its forward launches the hand-written
    kernel (``flash_attention_cuda``) once, and raises for what the
    kernel does not take (a dtype other than f32 or bf16, a head dim
    other than 32, 64, 112 or 128); ``q_chunk`` and ``kv_chunk`` are the
    kernel's business there (its own 64 x 64 tiles).  On CPU tensors the
    forward is the plain body over ``q_chunk`` x ``kv_chunk`` blocks.
    The gradient, on either device, recomputes attention in plain
    PyTorch one ``q_chunk`` of queries at a time (the reference's
    ``jax.checkpoint`` of each query chunk), whatever ``remat_chunks``
    says: the kernel's forward keeps nothing to differentiate.
    """
    del remat_chunks
    out = FlashAttentionFn.apply(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal,
        q.shape[-1] ** -0.5, kv_offset, q_chunk, kv_chunk, True)
    return out.transpose(1, 2)


def chunked_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_chunk: int,
    kv_chunk: int,
    kv_offset: int = 0,
    remat_chunks: bool = True,
) -> torch.Tensor:
    """The plain body of :func:`chunked_attention` on any device: the
    blockwise softmax of ``flash_attention_plain`` over ``q_chunk`` x
    ``kv_chunk`` blocks, as the JAX package's pure-XLA version runs it.
    With ``remat_chunks`` (the reference's ``jax.checkpoint`` of each
    query chunk) the backward recomputes one query chunk at a time
    (:class:`FlashAttentionFn` with the plain forward); without it,
    autograd keeps every block's scores of the forward."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    scale = q.shape[-1] ** -0.5
    if remat_chunks:
        out = FlashAttentionFn.apply(qt, kt, vt, causal, scale, kv_offset,
                                     q_chunk, kv_chunk, False)
    else:
        out = flash_attention_plain(
            qt, kt, vt, causal=causal, scale=scale, kv_offset=kv_offset,
            q_blk=min(q_chunk, q.shape[1]), k_blk=min(kv_chunk, k.shape[1]))
    return out.transpose(1, 2)


def chunked_attention_kv_parallel(*args, **kwargs):
    """Context-parallel attention over a mesh's 'model' axis.  It exists
    only under a mesh scheme, and ``parallel/*`` is not ported."""
    raise NotImplementedError(
        "chunked_attention_kv_parallel needs the mesh schemes of "
        "parallel/* (ROADMAP queue 1 item 12), which are not ported")


def gated_mlp(x: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """SiLU-gated MLP (llama family)."""
    g = F.silu(x @ wg)
    return ((g * (x @ wu)) @ wd).to(x.dtype)


def gelu_mlp(x: torch.Tensor, wu, wd) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return (F.gelu(x @ wu, approximate="tanh") @ wd).to(x.dtype)


def relu2_mlp(x: torch.Tensor, wu, wd) -> torch.Tensor:
    """Squared-ReLU MLP (nemotron/minitron family)."""
    h = F.relu(x @ wu)
    return ((h * h) @ wd).to(x.dtype)
