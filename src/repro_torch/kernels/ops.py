"""Public entry points for the kernels, the counterpart of
``repro.kernels.ops``.

``backend`` selects the execution tier:
  * ``"ref"``     — the plain PyTorch oracle (the CPU implementation);
  * ``"variant"`` — the registry's aspect variant (xnor ops only), which
    is kernel 1, ``xnor_gemm_cuda``, launched with those aspects;
  * ``"cuda"``    — the hand-written CUDA kernel, in place of the
    reference's ``"pallas"``.

On CPU tensors the ``"variant"`` and ``"cuda"`` tiers compute the
kernels' plain versions; on CUDA tensors they launch the kernel or
raise.  There is no ``interpret`` argument: a CUDA kernel has no
interpret mode.  ``"pallas"`` raises and names ``"cuda"``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.ref import attention_ref, xnor_gemm_ref
from repro_torch.kernels.registry import get_variant
from repro_torch.kernels.xnor_popcount import (
    N_BLK,
    P_BLK,
    _norm_aspects,
    xnor_gemm_cuda,
)


def _check_backend(backend: str, allowed: tuple) -> None:
    if backend == "pallas":
        raise ValueError(
            'backend "pallas" is the JAX package\'s TPU kernel; the port\'s '
            'hand-written kernel is backend="cuda"')
    if backend not in allowed:
        raise ValueError(f"unknown backend {backend!r}; have {allowed}")


def xnor_gemm(
    a: torch.Tensor,
    w: torch.Tensor,
    *,
    k_true: int,
    aspects: tuple = ("X", "Y", "Z"),
    backend: str = "ref",
    p_blk: int = P_BLK,
    n_blk: int = N_BLK,
) -> torch.Tensor:
    """a (B,P,Kw) int32, w (N,Kw) int32 -> (B,P,N) int32.  The tiles
    default to the CUDA kernel's own (64), not the TPU's 128."""
    _check_backend(backend, ("ref", "variant", "cuda"))
    if backend == "ref":
        return xnor_gemm_ref(a, w, k_true)
    if backend == "variant":
        name = "".join(_norm_aspects(aspects))
        return get_variant(name).builder(a, w, k_true)
    return xnor_gemm_cuda(a, w, k_true, aspects, p_blk=p_blk, n_blk=n_blk)


def binary_conv2d(
    x_words: torch.Tensor,
    w_words: torch.Tensor,
    *,
    k_true: int,
    aspects: tuple = ("X", "Y", "Z"),
    backend: str = "ref",
    p_blk: int = P_BLK,
    n_blk: int = N_BLK,
) -> torch.Tensor:
    """Packed 3x3 SAME conv = window extraction + xnor GEMM.
    x_words (B,H,W,Cw), w_words (Cout, 9*Cw) -> (B,H,W,Cout) int32."""
    from repro_torch.bnn.layers import extract_patch_words

    b, h, w_, _ = x_words.shape
    patches = extract_patch_words(x_words).reshape(b, h * w_, -1)
    out = xnor_gemm(
        patches, w_words, k_true=k_true, aspects=aspects, backend=backend,
        p_blk=p_blk, n_blk=n_blk,
    )
    return out.reshape(b, h, w_, -1)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    backend: str = "cuda",
    q_blk: int = 128,
    k_blk: int = 128,
) -> torch.Tensor:
    """q (B,H,Sq,D); k,v (B,Hkv,Sk,D) -> (B,H,Sq,D) in ``q.dtype``, causal
    over the suffix alignment (key j visible to query i iff
    j <= i + Sk - Sq).  As in the reference, the kernel tier refuses Sq
    or Sk that are not multiples of ``q_blk`` / ``k_blk`` (each clipped
    to its length); the CUDA kernel itself runs its own 64 x 64 tiles
    and masks ragged tails."""
    if backend == "ref":
        return attention_ref(q, k, v, causal=causal, scale=scale).to(q.dtype)
    _check_backend(backend, ("ref", "cuda"))
    Sq, Sk = q.shape[2], k.shape[2]
    q_blk, k_blk = min(q_blk, Sq), min(k_blk, Sk)
    if Sq % q_blk or Sk % k_blk:
        raise ValueError("Sq/Sk must be multiples of the block sizes")
    return flash_attention_cuda(q, k, v, causal=causal, scale=scale,
                                kv_offset=Sk - Sq)
