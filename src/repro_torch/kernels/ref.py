"""Plain PyTorch versions of the kernels — the 'CPU' implementation in
the paper's sense, and the ground truth the CUDA kernels are held to.

The xnor GEMM loops over the packed reduction axis and accumulates into
a (B, P, N) int32, so it never materializes the (B, P, N, Kw) xnor
tensor (gigabytes at CIFAR-10 full width and batch 16).
"""

from __future__ import annotations

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
