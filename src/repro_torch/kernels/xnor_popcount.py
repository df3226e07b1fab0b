"""The packed xnor/popcount binary GEMM as a CUDA kernel for Hopper.

``xnor_gemm_cuda(a, w, k_true, aspects)`` computes ``a (B, P, Kw) int32 x
w (N, Kw) int32 -> (B, P, N) int32`` with the exact {-1,+1} dot product
``2 * popcount(xnor) - k_true``.  It replaces the Pallas TPU kernel
``repro.kernels.xnor_popcount.xnor_gemm_pallas``; the kernel source is
``csrc/xnor_gemm.cu``.

X/Y/Z aspect mapping (paper §II-C, CUDA as the paper wrote it):
  X (data)   -> one block per image
  Y (window) -> one block per tile of ``p_blk`` windows
  Z (neuron) -> one block per tile of ``n_blk`` neurons
An aspect axis is a grid dimension; a non-aspect axis is a serial loop
inside the block.  One kernel gives all seven parallel configurations.

On a CPU tensor the wrapper computes the plain version
(``ref.xnor_gemm_ref``); on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import xnor_gemm_ref

ASPECTS_ALL = ("X", "Y", "Z")
# the port's own tiles: a 16 x 16 thread grid, up to 4 x 4 outputs each
P_BLK = 64
N_BLK = 64
_TILE_STEP = 16
_MAX_BLK = 64


def _norm_aspects(aspects) -> tuple:
    s = frozenset(aspects)
    bad = s - set(ASPECTS_ALL)
    if bad:
        raise ValueError(f"unknown aspects {bad}")
    if not s:
        raise ValueError("a parallel configuration needs >= 1 aspect")
    return tuple(a for a in ASPECTS_ALL if a in s)  # canonical X,Y,Z order


def _fit_tile(blk: int, extent: int) -> int:
    """Clamp a tile to the extent it covers, in steps of 16."""
    if blk <= 0 or blk % _TILE_STEP or blk > _MAX_BLK:
        raise ValueError(
            f"tile {blk} must be a positive multiple of {_TILE_STEP} "
            f"<= {_MAX_BLK}"
        )
    need = -(-max(extent, 1) // _TILE_STEP) * _TILE_STEP
    return min(blk, need)


def check_operands(a: torch.Tensor, w: torch.Tensor) -> None:
    if a.dtype != torch.int32 or w.dtype != torch.int32:
        raise TypeError(f"xnor GEMM takes int32 words, got {a.dtype}, {w.dtype}")
    if a.dim() != 3 or w.dim() != 2 or a.shape[2] != w.shape[1]:
        raise ValueError(
            f"xnor GEMM needs a (B,P,Kw), w (N,Kw); got {tuple(a.shape)}, "
            f"{tuple(w.shape)}"
        )
    if a.device != w.device:
        raise ValueError(f"operands on {a.device} and {w.device}")


def xnor_gemm_cuda(
    a: torch.Tensor,
    w: torch.Tensor,
    k_true: int,
    aspects: Sequence[str] = ASPECTS_ALL,
    *,
    p_blk: int = P_BLK,
    n_blk: int = N_BLK,
) -> torch.Tensor:
    """xnor GEMM under the `aspects` decomposition.  a (B,P,Kw) int32,
    w (N,Kw) int32 -> (B,P,N) int32."""
    par = _norm_aspects(aspects)
    check_operands(a, w)
    B, P, Kw = a.shape
    N = w.shape[0]
    p_blk = _fit_tile(p_blk, P)
    n_blk = _fit_tile(n_blk, N)
    if a.device.type == "cpu":
        return xnor_gemm_ref(a, w, k_true)
    if a.device.type != "cuda":
        raise ValueError(f"xnor_gemm_cuda: unsupported device {a.device}")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("xnor_gemm_cuda needs contiguous operands")
    out = torch.empty((B, P, N), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    mask = sum(1 << ASPECTS_ALL.index(x) for x in par)
    lib = build.load_library("xnor_gemm")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.xnor_gemm_launch(
            a.data_ptr(), w.data_ptr(), out.data_ptr(), B, P, N, Kw,
            int(k_true), mask, p_blk, n_blk, stream,
        )
    build.check(lib, "xnor_gemm", rc)
    xnor_gemm_cuda.launches += 1
    return out


xnor_gemm_cuda.launches = 0
