"""The packed xnor/popcount binary GEMM as a CUDA kernel for Hopper.

``xnor_gemm_cuda(a, w, k_true, aspects)`` computes ``a (B, P, Kw) int32 x
w (N, Kw) int32 -> (B, P, N) int32`` with the exact {-1,+1} dot product
``2 * popcount(xnor) - k_true``.  It replaces the Pallas TPU kernel
``repro.kernels.xnor_popcount.xnor_gemm_pallas``; the kernel source is
``csrc/xnor_gemm.cu``.  The kernel runs the product on the 1-bit tensor
cores in its AND form (``xnor_gemm_and_plain`` is that form in plain
PyTorch).

X/Y/Z aspect mapping (paper §II-C, CUDA as the paper wrote it):
  X (data)   -> one block per image
  Y (window) -> one block per tile of ``p_blk`` windows
  Z (neuron) -> one block per tile of ``n_blk`` neurons
An aspect axis is a grid dimension; a non-aspect axis is a serial loop
inside the block.  One kernel gives all seven parallel configurations.
``launch_plan`` and ``block_share`` are the launch's arithmetic in
Python (the kernel decodes its block the same way); the CPU tests check
that the blocks cover every output once.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence

import torch

from repro_torch.bnn.binarize import popcount
from repro_torch.kernels import build

ASPECTS_ALL = ("X", "Y", "Z")
# the registry's tiles (p_blk windows, n_blk neurons a block under Y, Z):
# one 64 x 64 MMA block tile where both are aspects
P_BLK = 64
N_BLK = 64
_TILE_STEP = 16
_MAX_BLK = 64
# the kernel's constants (csrc/xnor_gemm.cu)
K_CHUNK = 32          # reduction words a ring stage holds
K_STEP = 8            # words of one m16n8k256 step
TILE_COLS = 64        # neurons of a block tile
TILE_ROWS = (64, 16)  # rows of a block tile: tile 0, tile 1 (<= 16 rows)
STAGES = (4, 6)       # depth of the cp.async ring: tile 0, tile 1
_PITCH = K_CHUNK + 8


def _norm_aspects(aspects) -> tuple:
    s = frozenset(aspects)
    bad = s - set(ASPECTS_ALL)
    if bad:
        raise ValueError(f"unknown aspects {bad}")
    if not s:
        raise ValueError("a parallel configuration needs >= 1 aspect")
    return tuple(a for a in ASPECTS_ALL if a in s)  # canonical X,Y,Z order


_MASKS: dict = {}


def aspect_mask(aspects) -> int:
    """The kernel's ``par_mask`` (bit 0 X, bit 1 Y, bit 2 Z), cached by
    the aspects as given."""
    key = tuple(aspects)
    mask = _MASKS.get(key)
    if mask is None:
        mask = sum(1 << ASPECTS_ALL.index(x) for x in _norm_aspects(key))
        _MASKS[key] = mask
    return mask


def _fit_tile(blk: int, extent: int) -> int:
    """Clamp a tile to the extent it covers, in steps of 16."""
    if blk <= 0 or blk % _TILE_STEP or blk > _MAX_BLK:
        raise ValueError(
            f"tile {blk} must be a positive multiple of {_TILE_STEP} "
            f"<= {_MAX_BLK}"
        )
    need = -(-max(extent, 1) // _TILE_STEP) * _TILE_STEP
    return min(blk, need)


@dataclass(frozen=True)
class LaunchPlan:
    """One launch of ``xnor_gemm_kernel``: what the wrapper passes and
    what each block does."""

    grid: int            # blocks: B x ceil(P/p_blk) x ceil(N/n_blk), aspects only
    rows_per_block: int  # most (image, window) rows a block owns
    cols_per_block: int  # most neurons a block owns
    tile: int            # 0: 64 x 64 block tiles; 1: 16 x 64
    tile_rows: int
    k_chunks: int        # ring steps of K_CHUNK words per block tile
    k_steps: int         # m16n8k256 steps over the padded reduction
    kw_padded: int       # Kw rounded up to whole ring stages (zeros added)
    copy_words: int      # words per cp.async: 4 (16 bytes) or 1
    smem_bytes: int


@functools.lru_cache(maxsize=4096)
def launch_plan(B: int, P: int, N: int, Kw: int, mask: int, p_blk: int,
                n_blk: int, aligned: bool = True) -> LaunchPlan:
    """The launch of a (B,P,Kw) x (N,Kw) product under `mask`, with tiles
    already fitted (``_fit_tile``); `aligned`: both operands start on a
    16-byte boundary."""
    rows = (1 if mask & 1 else B) * (min(p_blk, P) if mask & 2 else P)
    cols = min(n_blk, N) if mask & 4 else N
    grid = 1
    if mask & 1:
        grid *= B
    if mask & 2:
        grid *= -(-P // p_blk)
    if mask & 4:
        grid *= -(-N // n_blk)
    tile = 1 if rows <= TILE_ROWS[1] else 0
    tm = TILE_ROWS[tile]
    k_chunks = max(1, -(-Kw // K_CHUNK))
    # ring stages, output tile, global row of each tile row
    smem_words = (STAGES[tile] * (tm + TILE_COLS) * _PITCH
                  + tm * (TILE_COLS + 8) + tm)
    return LaunchPlan(
        grid=grid, rows_per_block=rows, cols_per_block=cols, tile=tile,
        tile_rows=tm, k_chunks=k_chunks,
        k_steps=k_chunks * K_CHUNK // K_STEP, kw_padded=k_chunks * K_CHUNK,
        copy_words=4 if (Kw % 4 == 0 and aligned) else 1,
        smem_bytes=4 * smem_words,
    )


def block_share(B: int, P: int, N: int, mask: int, p_blk: int, n_blk: int,
                block: int) -> tuple:
    """(b0, nb, p0, pc, n0, nc) of one block, as the kernel decodes
    ``blockIdx.x``: images b0..b0+nb, windows p0..p0+pc, neurons
    n0..n0+nc.  Its rows are the nb x pc (image, window) pairs,
    image-major, walked in block tiles of ``tile_rows`` x ``TILE_COLS``."""
    g = block
    b0, nb, p0, pc, n0, nc = 0, B, 0, P, 0, N
    if mask & 1:
        b0, nb, g = g % B, 1, g // B
    if mask & 2:
        pt = -(-P // p_blk)
        p0 = (g % pt) * p_blk
        pc, g = min(p_blk, P - p0), g // pt
    if mask & 4:
        nt = -(-N // n_blk)
        n0 = (g % nt) * n_blk
        nc = min(n_blk, N - n0)
    return b0, nb, p0, pc, n0, nc


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


def xnor_gemm_and_plain(
    a: torch.Tensor, w: torch.Tensor, k_true: int
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: per bit lane
    ``xnor(a, w) = 1 - a - w + 2 (a & w)``, so over the ``L = 32 Kw``
    lanes of the real words

        agree = L - popc_a[row] - popc_w[neuron] + 2 sum popc(a & w)

    for any bits, and the result is ``2 agree - k_true``.  Loops over the
    reduction axis like ``ref.xnor_gemm_ref``."""
    b, p, kw = a.shape
    n = w.shape[0]
    both = torch.zeros((b, p, n), dtype=torch.int32, device=a.device)
    for k in range(kw):
        both += popcount(a[:, :, k, None] & w[None, None, :, k])
    pop_a = popcount(a).sum(-1, dtype=torch.int32)[:, :, None]
    pop_w = popcount(w).sum(-1, dtype=torch.int32)
    return 2 * (32 * kw - pop_a - pop_w + 2 * both) - k_true


_launch = None


def _launcher():
    """The bound C entry point (built and bound on first use)."""
    global _launch
    if _launch is None:
        _launch = build.load_library("xnor_gemm").xnor_gemm_launch
    return _launch


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
    mask = aspect_mask(aspects)
    check_operands(a, w)
    B, P, Kw = a.shape
    N = w.shape[0]
    p_blk = _fit_tile(p_blk, P)
    n_blk = _fit_tile(n_blk, N)
    if a.device.type == "cpu":
        return xnor_gemm_and_plain(a, w, k_true)
    if a.device.type != "cuda":
        raise ValueError(f"xnor_gemm_cuda: unsupported device {a.device}")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("xnor_gemm_cuda needs contiguous operands")
    out = torch.empty((B, P, N), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    pa, pw = a.data_ptr(), w.data_ptr()
    plan = launch_plan(B, P, N, Kw, mask, p_blk, n_blk, (pa | pw) % 16 == 0)
    launch = _launcher()
    dev = a.device.index
    args = (pa, pw, out.data_ptr(), B, P, N, Kw, int(k_true), mask, p_blk,
            n_blk, plan.tile, plan.copy_words == 4)
    if dev == torch.cuda.current_device():
        rc = launch(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            rc = launch(*args, torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        build.check(build.load_library("xnor_gemm"), "xnor_gemm", rc)
    xnor_gemm_cuda.launches += 1
    return out


xnor_gemm_cuda.launches = 0


def mma_probe(out: torch.Tensor, iters: int) -> None:
    """Launch ``xnor_mma_probe_kernel``: one block of 256 threads per 256
    elements of `out` (int32, on the card), each warp issuing ``8 x
    iters`` independent m16n8k256 AND/popc products (16 x 8 x 256
    bit-products each).  A measuring tool, not a kernel of the main
    path."""
    if out.dtype != torch.int32 or out.device.type != "cuda" or (
            out.numel() % 256 or not out.is_contiguous()):
        raise ValueError("mma_probe needs a contiguous int32 CUDA tensor "
                         "of a multiple of 256 elements")
    lib = build.load_library("xnor_gemm")
    with torch.cuda.device(out.device):
        rc = lib.xnor_mma_probe_launch(
            out.data_ptr(), out.numel() // 256, int(iters),
            torch.cuda.current_stream(out.device).cuda_stream)
    build.check(lib, "xnor_gemm", rc)
