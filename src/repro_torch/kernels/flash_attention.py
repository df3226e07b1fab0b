"""Blockwise online-softmax (flash) attention as a CUDA kernel for Hopper.

``flash_attention_cuda(q, k, v, *, causal, scale, kv_offset)`` computes
softmax attention for ``q (B, H, Sq, D)`` and ``k, v (B, Hkv, Sk, D)``,
``Hkv | H`` (GQA: query head ``h`` reads kv head ``h // (H // Hkv)``).
Causal masking is suffix-aligned with an explicit offset: key ``j`` is
visible to query ``i`` iff ``j <= i + kv_offset`` (``Sk - Sq`` for the
ops entry, the caller's own offset for ``chunked_attention``).  Inputs
are f32 or bf16, the softmax statistics f32, the output in the input
type.  It replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas``; the kernel
source is ``csrc/flash_attention.cu``, two kernels dispatched on dtype:
bf16 on the tensor cores (``mma.sync``, P rounded to bf16 for the P.V
product, f32 accumulators), f32 on scalar f32 FMAs (the tensor cores
would round f32 operands to TF32).  bf16 operands are staged by 16-byte
``cp.async`` copies, so their base pointers and (b, h, s) strides must
be 16-byte aligned; the wrapper refuses others.

With ``return_lse=True`` both return ``(out, lse)``: ``lse`` (B, H, Sq)
float32, each row's natural-log log-sum-exp of its scaled visible
scores, ``-inf`` for a row that saw no key.  The kernel writes it from
a second instantiation, so a launch that does not ask runs the same code
as before; ``models.modules.chunked_attention_kv_parallel`` launches it
once per KV part and merges the parts by it.

On a CPU tensor the wrapper computes the plain version
(:func:`flash_attention_plain`); on a CUDA tensor it launches the kernel
or raises.  Ragged Sq and Sk are masked inside the kernel, so neither
path pads.

The kernel has no backward, nor has the Pallas kernel.  The gradient
comes from :class:`FlashAttentionFn`: its forward is the kernel (or,
on CPU tensors, the plain version), its backward recomputes attention
one query chunk at a time under autograd (:func:`attention_rows`), as
the JAX package differentiates its pure-XLA ``chunked_attention``
through ``jax.checkpoint`` of each query chunk.  The backward holds one
chunk's scores at a time, never (B, H, Sq, Sk).

Masked keys get probability exactly 0, and key tiles masked for every
query of a tile are skipped; for a query that sees at least one key this
is the Pallas kernel's arithmetic (its finite -1e30 mask underflows to
the same 0).  A query that sees no key at all (``i + kv_offset < 0``)
gets a zero row here; the Pallas kernel returns the mean of ``v`` there
and ``attention_ref`` NaN.  A single launch on the LM path never asks
(``kv_offset >= 0``); the context-parallel attention's KV parts do
(their offsets are negative), and there the row's ``lse`` of ``-inf``
gives it no weight in the merge.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

NEG = -1e30
# the kernel's tiles (csrc/flash_attention.cu kBQ, kBK)
Q_TILE = 64
K_TILE = 64
HEAD_DIMS = (32, 64, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"attention needs q (B,H,Sq,D), k and v (B,Hkv,Sk,D); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head dim")
    if k.shape[1] == 0 or h % k.shape[1]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[1]} kv heads")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")


def check_aligned(*tensors: torch.Tensor) -> None:
    """Refuse bf16 operands the kernel's 16-byte copies cannot read:
    a base pointer or a (b, h, s) stride off a 16-byte boundary."""
    for t in tensors:
        size = t.element_size()
        if t.data_ptr() % 16 or any(s * size % 16 for s in t.stride()[:3]):
            raise ValueError(
                f"flash_attention_cuda needs 16-byte aligned bf16 rows: "
                f"pointer {t.data_ptr() % 16} bytes past a boundary, "
                f"strides {tuple(t.stride())}")


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    kv_offset: int | None = None,
    q_blk: int = Q_TILE,
    k_blk: int = K_TILE,
    return_lse: bool = False,
):
    """The kernel's function in plain PyTorch, block by block: running
    max, sum and accumulator in f32 over key blocks of ``k_blk``, for
    each query block of ``q_blk``.  Same shapes, masking and output type
    as :func:`flash_attention_cuda`; ``kv_offset`` defaults to
    ``Sk - Sq``.  With ``return_lse``, ``(out, lse)``: ``m + log(l)`` of
    each row, ``-inf`` where ``l`` is 0."""
    check_operands(q, k, v)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = float(scale if scale is not None else D ** -0.5)
    off = Sk - Sq if kv_offset is None else int(kv_offset)
    if q_blk <= 0 or k_blk <= 0:
        raise ValueError(f"blocks must be positive, got {q_blk}, {k_blk}")
    qg = q.reshape(B, Hkv, g, Sq, D).float()
    kf, vf = k.float(), v.float()
    out = torch.empty((B, Hkv, g, Sq, D), dtype=torch.float32,
                      device=q.device)
    lse = torch.empty((B, Hkv, g, Sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, q_blk):
        qb = qg[:, :, :, q0:q0 + q_blk]
        nq = qb.shape[3]
        qpos = torch.arange(q0, q0 + nq, device=q.device)
        m = torch.full((B, Hkv, g, nq, 1), NEG, device=q.device)
        l = torch.zeros((B, Hkv, g, nq, 1), device=q.device)
        acc = torch.zeros((B, Hkv, g, nq, D), device=q.device)
        k_end = Sk
        if causal:   # keys no query of this block can see
            k_end = max(0, min(Sk, q0 + nq - 1 + off + 1))
        for k0 in range(0, k_end, k_blk):
            kb = kf[:, :, None, k0:k0 + k_blk]
            vb = vf[:, :, None, k0:k0 + k_blk]
            kpos = torch.arange(k0, k0 + kb.shape[3], device=q.device)
            s = torch.einsum("bkgqd,bkgjd->bkgqj", qb, kb) * scale
            if causal:
                ok = kpos[None, :] <= qpos[:, None] + off
                s = torch.where(ok, s, NEG)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            if causal:   # masked keys weigh exactly 0, as in the kernel
                p = torch.where(ok, p, 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bkgqj,bkgjd->bkgqd", p, vb)
            m = m_new
        out[:, :, :, q0:q0 + nq] = torch.where(
            l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
        lse[:, :, :, q0:q0 + nq] = torch.where(
            l > 0, m + torch.log(torch.where(l > 0, l, 1.0)),
            -math.inf)[..., 0]
    out = out.reshape(B, H, Sq, D).to(q.dtype)
    return (out, lse.reshape(B, H, Sq)) if return_lse else out


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    kv_offset: int | None = None,
    return_lse: bool = False,
):
    """Flash attention, q (B,H,Sq,D), k/v (B,Hkv,Sk,D) -> (B,H,Sq,D) in
    ``q.dtype``.  ``kv_offset`` defaults to ``Sk - Sq`` and may be
    negative.  Operands may be strided views (for example (B,S,H,D)
    tensors transposed to (B,H,S,D)) as long as the head-dim axis is
    dense (and, for bf16, 16-byte aligned: :func:`check_aligned`); the
    output has the layout of ``q``.  With ``return_lse``, ``(out,
    lse)``, ``lse`` a dense (B,H,Sq) float32 tensor; such launches are
    also counted in ``flash_attention_cuda.lse_launches``.

    The launch goes through the custom ops ``repro_torch::flash_attention``
    and ``repro_torch::flash_attention_lse`` (:func:`_flash_op`), so fake
    tensors, DTensors and ``FlopCounterMode`` see one op per call."""
    check_operands(q, k, v)
    Sq, D = q.shape[2], q.shape[3]
    scale = float(scale if scale is not None else D ** -0.5)
    off = k.shape[2] - Sq if kv_offset is None else int(kv_offset)
    if q.device.type == "cuda":
        check_cuda_operands(q, k, v)
    elif q.device.type != "cpu":
        raise ValueError(f"flash_attention_cuda: unsupported device "
                         f"{q.device}")
    if return_lse:
        o, lse = torch.ops.repro_torch.flash_attention_lse(
            q, k, v, bool(causal), scale, off, Q_TILE, K_TILE)
        return o, lse
    return torch.ops.repro_torch.flash_attention(
        q, k, v, bool(causal), scale, off, Q_TILE, K_TILE)


flash_attention_cuda.launches = 0
flash_attention_cuda.lse_launches = 0


def check_cuda_operands(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """What the kernel takes, read from shapes, dtypes and strides alone
    (so fake tensors and DTensors are checked too); the alignment of
    bf16 pointers is checked at the launch."""
    B, H, _, D = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention_cuda takes float32 or bfloat16 operands of "
            f"one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda takes head dims "
                         f"{HEAD_DIMS}, got {D}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs a dense head-dim axis")
    if B > 65535 or H > 65535:
        raise ValueError(f"B {B} or H {H} exceeds the grid's 65535")


def _launch(q, k, v, causal: bool, scale: float, off: int,
            return_lse: bool):
    """One launch of the kernel on real CUDA tensors: (out, lse or
    None)."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    check_cuda_operands(q, k, v)
    if q.dtype == torch.bfloat16:
        check_aligned(q, k, v)
    # the output in q's layout: (B,S,H,D) storage stays (B,S,H,D)
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if o.numel() == 0 or Sk == 0:
        o.zero_()
        return o, None if lse is None else lse.fill_(-math.inf)
    lib = build.load_library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), _DTYPES[q.dtype],
            B, H, Hkv, Sq, Sk, D, *strides, scale, int(bool(causal)), off,
            stream,
        )
    build.check(lib, "flash_attention", rc)
    flash_attention_cuda.launches += 1
    if return_lse:
        flash_attention_cuda.lse_launches += 1
    return o, lse


# ---------------------------------------------------------------------------
# The kernel as custom ops: a body (the launch on CUDA tensors, the plain
# version on CPU tensors), a fake implementation (shapes and dtypes), a
# FLOP formula and a DTensor sharding rule
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float, kv_offset: int, q_blk: int,
              k_blk: int) -> torch.Tensor:
    """Kernel 3: one launch on CUDA tensors; on CPU tensors the plain
    version over ``q_blk`` x ``k_blk`` blocks (the kernel ignores
    them: its tiles are 64 x 64)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     kv_offset=kv_offset, q_blk=q_blk,
                                     k_blk=k_blk)
    return _launch(q, k, v, causal, scale, kv_offset, False)[0]


@torch.library.custom_op("repro_torch::flash_attention_lse",
                         mutates_args=())
def _flash_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, scale: float, kv_offset: int, q_blk: int,
                  k_blk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 3 with its log-sum-exp output: ``(out, lse)``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     kv_offset=kv_offset, q_blk=q_blk,
                                     k_blk=k_blk, return_lse=True)
    return _launch(q, k, v, causal, scale, kv_offset, True)


def _fake_out(q: torch.Tensor) -> torch.Tensor:
    # the kernel writes q's layout, the plain version a dense tensor
    if q.device.type == "cpu":
        return q.new_empty(q.shape)
    return torch.empty_like(q)


@_flash_op.register_fake
def _(q, k, v, causal, scale, kv_offset, q_blk, k_blk):
    return _fake_out(q)


@_flash_lse_op.register_fake
def _(q, k, v, causal, scale, kv_offset, q_blk, k_blk):
    return _fake_out(q), q.new_empty(q.shape[:3], dtype=torch.float32)


def visible_pairs(sq: int, sk: int, kv_offset: int, causal: bool) -> int:
    """(query, key) pairs a launch computes: all ``sq * sk`` without
    causal masking, else the keys ``j <= i + kv_offset`` of each query
    ``i`` (a closed form of ``sum_i clip(i + kv_offset + 1, 0, sk)``)."""
    if not causal:
        return sq * sk
    i0 = min(sq, max(0, -kv_offset))          # first query seeing a key
    i1 = min(sq, max(i0, sk - kv_offset - 1))  # first seeing all of them
    n = i1 - i0
    ramp = n * (2 * (i0 + kv_offset + 1) + n - 1) // 2
    return ramp + (sq - i1) * sk


def flash_flops(q_shape, k_shape, causal: bool, kv_offset: int) -> int:
    """The kernel's FLOPs: two products (q k^T and p v) of 2 * D each
    per visible (query, key) pair and query head: ``4 B H D pairs``."""
    B, H, Sq, D = q_shape
    return 4 * B * H * D * visible_pairs(Sq, k_shape[2], kv_offset, causal)


def _flop_formula(q_shape, k_shape, v_shape, causal, scale, kv_offset,
                  q_blk, k_blk, *args, out_shape=None, **kwargs) -> int:
    return flash_flops(q_shape, k_shape, causal, kv_offset)


def _register_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula

    register_flop_formula([torch.ops.repro_torch.flash_attention,
                           torch.ops.repro_torch.flash_attention_lse])(
        _flop_formula)


def _register_sharding() -> None:
    """DTensor runs the kernel per local shard: batch over any mesh dim,
    query and kv heads over 'model' where both counts divide its size
    (a query head's kv head then lies on its own shard), else
    replicated; DTensor redistributes operands placed otherwise."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    def rule(q, k, v, causal, scale, kv_offset, q_blk, k_blk, *, n_out):
        strategies = []
        dims = [0]
        names = q.mesh.mesh_dim_names or ()
        if "model" in names:
            m = q.mesh.size(names.index("model"))
            if q.shape[1] % m == 0 and k.shape[1] % m == 0:
                dims.append(1)
        # the log-sum-exp (B,H,Sq) shards as the output (B,H,Sq,D) does
        for placement in [Replicate()] + [Shard(d) for d in dims]:
            strategies.append(
                ([placement] * n_out, [placement] * 3 + [None] * 5))
        return strategies

    register_sharding(torch.ops.repro_torch.flash_attention.default)(
        lambda *a, **kw: rule(*a, **kw, n_out=1))
    register_sharding(torch.ops.repro_torch.flash_attention_lse.default)(
        lambda *a, **kw: rule(*a, **kw, n_out=2))


_register_formulas()
try:
    import torch.distributed.tensor  # noqa: F401  (absent without c10d)
except ImportError:
    pass
else:
    _register_sharding()


def attention_rows(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    scale: float,
    kv_offset: int,
) -> torch.Tensor:
    """Softmax attention of a slice of queries against the keys, in one
    piece: q (B,H,n,D), k/v (B,Hkv,Sk,D) -> (B,H,n,D) float32, the
    scores (B,H,n,Sk') of the keys any of these queries can see held
    whole.  Same function as :func:`flash_attention_plain` (masked keys
    weigh exactly 0, a query that sees no key gets a zero row), without
    the running max and rescales: :class:`FlashAttentionFn` recomputes
    it under autograd one query chunk at a time."""
    B, H, n, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = H // Hkv
    k_end = max(0, min(Sk, n + kv_offset)) if causal else Sk
    qg = q.float().reshape(B, Hkv, g, n, D)
    kb = k.float()[:, :, None, :k_end]
    vb = v.float()[:, :, None, :k_end]
    s = torch.einsum("bkgqd,bkgjd->bkgqj", qg, kb) * scale
    if causal:
        ok = (torch.arange(k_end, device=q.device)[None, :]
              <= torch.arange(n, device=q.device)[:, None] + kv_offset)
        p = torch.where(ok, torch.softmax(torch.where(ok, s, NEG), dim=-1),
                        0.0)
    else:
        p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqj,bkgjd->bkgqd", p, vb).reshape(B, H, n, D)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a gradient: q (B,H,Sq,D), k/v (B,Hkv,Sk,D) ->
    (B,H,Sq,D), differentiable in q, k and v.

    ``apply(q, k, v, causal, scale, kv_offset, q_chunk, kv_chunk,
    kernel)``.  The forward is :func:`flash_attention_cuda` when
    ``kernel`` is true (one launch on CUDA tensors), else
    :func:`flash_attention_plain`; on CPU tensors both are the plain
    version over ``q_chunk`` x ``kv_chunk`` blocks.  Only q, k and v are
    saved.  The backward recomputes the attention of one ``q_chunk``
    slice of the queries at a time (:func:`attention_rows`, float32)
    and takes its gradient with ``torch.autograd.grad``: the reference's
    ``jax.checkpoint(q_body)``, whose XLA body becomes plain PyTorch
    here, held to one chunk's scores.  dk and dv sum over the chunks in
    float32."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, kv_offset: int,
                q_chunk: int, kv_chunk: int, kernel: bool):
        q_blk = min(q_chunk, q.shape[2]) or 1
        k_blk = min(kv_chunk, k.shape[2]) or 1
        if kernel:
            check_operands(q, k, v)
            if q.device.type == "cuda":
                check_cuda_operands(q, k, v)
            out = torch.ops.repro_torch.flash_attention(
                q, k, v, bool(causal), float(scale), int(kv_offset), q_blk,
                k_blk)
        else:
            out = flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                        kv_offset=kv_offset, q_blk=q_blk,
                                        k_blk=k_blk)
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, scale, kv_offset, q_blk)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        causal, scale, off, q_blk = ctx.args
        dq, dk, dv = _per_shard(_recompute_grads, q, k, v, grad_out,
                                causal=causal, scale=scale, off=off,
                                q_blk=q_blk)
        return dq, dk, dv, None, None, None, None, None, None


def _recompute_grads(q, k, v, grad_out, *, causal: bool, scale: float,
                     off: int, q_blk: int):
    """(dq, dk, dv) of attention by recomputing it one ``q_blk`` slice
    of the queries at a time under autograd (float32)."""
    dq = torch.empty_like(q)
    # float32 leaves: the recompute runs in float32, so its gradients
    # stay float32 until the one rounding at the end
    kf = k.detach().float().requires_grad_()
    vf = v.detach().float().requires_grad_()
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, q.shape[2], q_blk):
        rows = slice(q0, q0 + q_blk)
        with torch.enable_grad():
            qi = q[:, :, rows].detach().float().requires_grad_()
            oi = attention_rows(qi, kf, vf, causal=causal, scale=scale,
                                kv_offset=off + q0)
            # a chunk that sees no key leaves its inputs unused
            gq, gk, gv = torch.autograd.grad(
                oi, (qi, kf, vf), grad_out[:, :, rows].float(),
                allow_unused=True)
        dq[:, :, rows] = 0 if gq is None else gq
        if gk is not None:
            dk += gk
            dv += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _per_shard(fn, q, k, *rest, **kw):
    """``fn(q, k, *rest, **kw)`` on tensors laid out as kernel 3's
    (B, H, S, D).  On DTensors it runs on the local shards under the
    op's sharding rule (batch shards, head shards where H and Hkv divide
    the mesh dim, everything else replicated) and returns DTensors of
    those placements, as the op runs the forward; on plain tensors it is
    ``fn`` itself."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(q, DTensor):
        return fn(q, k, *rest, **kw)
    mesh = q.device_mesh

    def keep(i, p):
        n = mesh.size(i)
        return isinstance(p, Shard) and (
            p.dim == 0 or (p.dim == 1 and q.shape[1] % n == 0
                           and k.shape[1] % n == 0))

    placements = tuple(p if keep(i, p) else Replicate()
                       for i, p in enumerate(q.placements))
    out = fn(*(t.redistribute(mesh, placements).to_local()
               for t in (q, k, *rest)), **kw)
    return tuple(DTensor.from_local(t, mesh, placements, run_check=False)
                 for t in out)
