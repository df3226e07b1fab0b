"""Plain PyTorch versions of the kernels — the 'CPU' implementation in
the paper's sense, and the ground truth the CUDA kernels are held to.

The xnor GEMM loops over the packed reduction axis and accumulates into
a (B, P, N) int32, so it never materializes the (B, P, N, Kw) xnor
tensor (gigabytes at CIFAR-10 full width and batch 16).

``attention_ref`` is the naive softmax attention, the oracle the flash
kernel and its blockwise plain version are held to.
"""

from __future__ import annotations

import math

import torch

from repro_torch.bnn.binarize import popcount


def xnor_gemm_ref(
    a: torch.Tensor, w: torch.Tensor, k_true: int
) -> torch.Tensor:
    """a (B,P,Kw) int32, w (N,Kw) int32 -> (B,P,N) int32 with
    ``2 * sum_k popcount(~(a ^ w)) - k_true``."""
    b, p, kw = a.shape
    n = w.shape[0]
    agree = torch.zeros((b, p, n), dtype=torch.int32, device=a.device)
    for k in range(kw):
        agree += popcount(~(a[:, :, k, None] ^ w[None, None, :, k]))
    return 2 * agree - k_true


def binary_conv2d_ref(
    x_words: torch.Tensor, w_words: torch.Tensor, k_true: int
) -> torch.Tensor:
    """Packed 3x3 SAME binary conv oracle (delegates to bnn.layers)."""
    from repro_torch.bnn.layers import conv_packed

    return conv_packed(x_words, w_words, k_true)


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Naive softmax attention oracle.

    q (B,H,Sq,D); k,v (B,Hkv,Sk,D) with H a multiple of Hkv (GQA);
    returns (B,H,Sq,D) float32.  Causal uses suffix alignment: query i
    attends to keys j <= i + (Sk - Sq), the rest get -inf.
    """
    _, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    group = H // Hkv
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None]
        kj = torch.arange(Sk, device=q.device)[None, :]
        logits = logits.masked_fill(~(kj <= qi + (Sk - Sq)), -math.inf)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv)
