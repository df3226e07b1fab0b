"""Shared neural modules: norms, RoPE, chunked attention, MLPs — the
counterpart of ``repro.models.modules``.

Numerics policy: activations in cfg.dtype (bf16), norms and softmax in
f32, residual stream in bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import (
    NEG,
    FlashAttentionFn,
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.parallel.constrain import constrain, split_dim


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


def chunked_attention_kv_parallel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_chunk: int,
    n_kv_parts: int = 16,
    remat_chunks: bool = True,
) -> torch.Tensor:
    """Context-parallel attention: the KV sequence is split into
    ``n_kv_parts`` parts (constrained over the mesh's 'model' axis), each
    part's blockwise-softmax partial is computed on its own and the
    parts are combined by a log-sum-exp merge.  q (B,Sq,H,D); k,v
    (B,Sk,Hkv,D), ``Sk % n_kv_parts == 0``; causal masking is suffix
    aligned (query i sees keys j <= i + Sk - Sq).  Returns (B,Sq,H,D) in
    q.dtype, differentiable in q, k and v.

    On CUDA tensors the forward launches kernel 3
    (``flash_attention_cuda`` with ``return_lse``) once per KV part that
    some query can see, on strided (B,H,S,D) views of the part, with the
    part's offset ``(Sk - Sq) - p * Sk / n_kv_parts`` (negative for all
    but the first part), and merges the parts' outputs by their
    log-sum-exps: ``lse = logsumexp_p lse_p``, ``out = sum_p
    exp(lse_p - lse) o_p`` (a part a row cannot see has ``lse_p = -inf``
    and weighs exactly 0).  On CPU tensors the forward is the plain body
    (:func:`chunked_attention_kv_parallel_plain`).  The backward, on
    either device, recomputes the plain body one ``q_chunk`` of queries
    at a time under autograd, as ``jax.checkpoint`` of the reference's
    q-chunk body does, whatever ``remat_chunks`` says: the kernel's
    forward keeps nothing to differentiate.

    A query that sees no key at all (``i + Sk - Sq < 0``, never on the LM
    path) gets the mean of ``v`` from the plain body, the reference's
    finite ``-1e30`` arithmetic, and a zero row from the kernel path,
    kernel 3's convention.
    """
    del remat_chunks
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    assert Sk % n_kv_parts == 0
    kp = Sk // n_kv_parts
    # the JAX package's pins of the parts over 'model' (identities on
    # plain tensors)
    k = constrain(k.reshape(B, n_kv_parts, kp, Hkv, D), ("pod", "data"),
                  "model", None, None, None).reshape(B, Sk, Hkv, D)
    v = constrain(v.reshape(B, n_kv_parts, kp, Hkv, D), ("pod", "data"),
                  "model", None, None, None).reshape(B, Sk, Hkv, D)
    return KVParallelAttentionFn.apply(q, k, v, causal, q_chunk, n_kv_parts)


def _kv_parallel_rows(q, k, v, *, causal: bool, n_kv_parts: int, q0: int,
                      Sq: int) -> torch.Tensor:
    """The reference's q-chunk body: queries ``q0 .. q0 + n`` of ``Sq``,
    q (B,n,H,D) against all of k, v (B,Sk,Hkv,D), everything in float32.
    Per KV part ``m_n``, ``l_n`` and ``acc_n`` with the finite ``-1e30``
    mask, then the log-sum-exp merge over the parts.  Returns (B,n,H,D)
    float32."""
    B, n, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    kp = Sk // n_kv_parts
    qg = split_dim(q.float(), 2, Hkv, g)       # (B,n,Hkv,g,D)
    kc = k.float().reshape(B, n_kv_parts, kp, Hkv, D)
    vc = v.float().reshape(B, n_kv_parts, kp, Hkv, D)
    s = torch.einsum("bqkgd,bpjkd->bpkgqj", qg, kc) * D ** -0.5
    if causal:                                 # s (B,n_parts,Hkv,g,n,kp)
        kpos = torch.arange(Sk, device=q.device).reshape(n_kv_parts, 1, 1,
                                                         1, kp)
        qpos = torch.arange(q0, q0 + n, device=q.device)[:, None]
        s = torch.where(kpos <= qpos + (Sk - Sq), s, NEG)
    m_n = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m_n)
    l_n = p.sum(dim=-1, keepdim=True)
    acc_n = torch.einsum("bpkgqj,bpjkd->bpkgqd", p, vc)
    # log-sum-exp combine across the part dim
    m = m_n.amax(dim=1, keepdim=True)
    w = torch.exp(m_n - m)
    lsum = (l_n * w).sum(dim=1)                # (B,Hkv,g,n,1)
    acc = (acc_n * w).sum(dim=1)               # (B,Hkv,g,n,D)
    return (acc / lsum).reshape(B, H, n, D).transpose(1, 2)


def chunked_attention_kv_parallel_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_chunk: int,
    n_kv_parts: int = 16,
) -> torch.Tensor:
    """The plain body of :func:`chunked_attention_kv_parallel` on any
    device, one ``q_chunk`` of queries at a time (the reference's scan
    over query chunks), differentiable by plain autograd."""
    Sq = q.shape[1]
    assert k.shape[1] % n_kv_parts == 0
    q_chunk = min(q_chunk, Sq)
    out = [_kv_parallel_rows(q[:, q0:q0 + q_chunk], k, v, causal=causal,
                             n_kv_parts=n_kv_parts, q0=q0, Sq=Sq)
           for q0 in range(0, Sq, q_chunk)]
    return torch.cat(out, dim=1).to(q.dtype)


def _kv_parallel_kernel(q, k, v, *, causal: bool, n_kv_parts: int):
    """Kernel 3 once per visible KV part, merged by log-sum-exp."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    kp = Sk // n_kv_parts
    qt = q.transpose(1, 2)
    outs, lses = [], []
    for p in range(n_kv_parts):
        off = (Sk - Sq) - p * kp
        if causal and Sq - 1 + off < 0:        # no query sees this part
            continue
        part = slice(p * kp, (p + 1) * kp)
        o, lse = flash_attention_cuda(
            qt, k[:, part].transpose(1, 2), v[:, part].transpose(1, 2),
            causal=causal, scale=D ** -0.5, kv_offset=off, return_lse=True)
        outs.append(o)
        lses.append(lse)
    if not lses:
        return torch.zeros_like(q)
    lse_p = torch.stack(lses)                  # (parts, B, H, Sq)
    lse = torch.logsumexp(lse_p, dim=0)
    # a row that saw no key anywhere: every weight exp(-inf) = 0
    lse = torch.where(torch.isinf(lse), 0.0, lse)
    w = torch.exp(lse_p - lse)[..., None]
    out = w[0] * outs[0].float()
    for i in range(1, len(outs)):
        out = out + w[i] * outs[i].float()
    return out.transpose(1, 2).to(q.dtype)


class KVParallelAttentionFn(torch.autograd.Function):
    """Context-parallel attention with a gradient: q (B,Sq,H,D), k/v
    (B,Sk,Hkv,D) -> (B,Sq,H,D).  ``apply(q, k, v, causal, q_chunk,
    n_kv_parts)``.  The forward is kernel 3 per KV part on CUDA tensors
    and the plain body on CPU tensors; only q, k and v are saved.  The
    backward recomputes :func:`_kv_parallel_rows` one ``q_chunk`` of
    queries at a time under ``torch.autograd.grad`` (float32; dk and dv
    summed over the chunks in float32).  On DTensors it recomputes on
    the local shards, as ``FlashAttentionFn``'s backward does (batch and
    divisible head shards kept, the KV parts gathered): autograd over
    whole DTensors is a path the card's torch refuses some views on."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_chunk: int, n_kv_parts: int):
        if q.device.type == "cpu":
            out = chunked_attention_kv_parallel_plain(
                q, k, v, causal=causal, q_chunk=q_chunk,
                n_kv_parts=n_kv_parts)
        else:
            out = _kv_parallel_kernel(q, k, v, causal=causal,
                                      n_kv_parts=n_kv_parts)
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, min(q_chunk, q.shape[1]) or 1, n_kv_parts)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        from repro_torch.kernels.flash_attention import _per_shard

        q, k, v = ctx.saved_tensors
        causal, q_blk, n_kv_parts = ctx.args
        dq, dk, dv = _per_shard(_kv_parallel_grads, q, k, v, grad_out,
                                head_dim=2, causal=causal, q_blk=q_blk,
                                n_kv_parts=n_kv_parts)
        return dq, dk, dv, None, None, None


def _kv_parallel_grads(q, k, v, grad_out, *, causal: bool, q_blk: int,
                       n_kv_parts: int):
    """(dq, dk, dv) of :func:`_kv_parallel_rows` on plain tensors,
    recomputed one ``q_blk`` of queries at a time (float32)."""
    Sq = q.shape[1]
    dq = torch.empty_like(q)
    kf = k.detach().float().requires_grad_()
    vf = v.detach().float().requires_grad_()
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, Sq, q_blk):
        rows = slice(q0, q0 + q_blk)
        with torch.enable_grad():
            qi = q[:, rows].detach().float().requires_grad_()
            oi = _kv_parallel_rows(qi, kf, vf, causal=causal,
                                   n_kv_parts=n_kv_parts, q0=q0, Sq=Sq)
            gq, gk, gv = torch.autograd.grad(
                oi, (qi, kf, vf), grad_out[:, rows].float())
        dq[:, rows] = gq
        dk += gk
        dv += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


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
