"""The float side of a Bi-Real unit around kernel 1, as two CUDA kernels.

A unit (``repro_torch.bnn.layers.bireal_unit``) is ``scale * conv3x3(
sign(x), sign(W)) + shift + shortcut(x)``.  Kernel 1 (``xnor_gemm_cuda``)
computes the binary conv's sums from packed patches; these two kernels
do the float work on either side of it (``csrc/bireal_unit.cu``):

* ``bireal_patches_cuda(x, stride)``: float32 x (B, H, W, C) -> kernel
  1's operand (B, Ho*Wo, 9*Cw) int32, the 3x3 patches of the sign words
  (``x >= 0`` is bit 1, tap-major, pad words 0) in one pass;
* ``bireal_epilogue_cuda(acc, corr, scale, shift, res)``: kernel 1's sums
  (B, P, N) int32 -> ``scale * float(acc + corr) + shift + res`` float32
  (B, Ho, Wo, N) in one pass, rounded as the plain chain rounds on the
  card, so the residual stream is the same to the bit.

They replace no TPU kernel: the JAX package has no Bi-Real Net.  Both are
bound by bytes (about 26 MB an image of Bi-Real Net-18 at 224x224 over
its 16 units, 7.9 us at 3.35 TB/s); the source says what their designs
do about it.  The plain versions (``bireal_patches_plain``,
``bireal_epilogue_plain``) are the chain of PyTorch operations the unit
ran before, and are what a wrapper computes for CPU tensors; for a CUDA
tensor it launches its kernel or raises.  Each wrapper counts its
launches in ``.launches``; they are not in ``repro_torch.kernels.KERNELS``
(whose launches a benchmark's device trace matches by kernel name), and
``UNIT_KERNELS`` is the tuple of the two.
"""

from __future__ import annotations

import torch

from repro_torch.bnn.binarize import pack_bits, packed_len
from repro_torch.bnn.layers import (
    REAL_DTYPE,
    extract_patch_words,
    strided_side,
)
from repro_torch.kernels import build

# the kernels' constants (csrc/bireal_unit.cu)
THREADS = 256
SMEM_MAX = 48 * 1024
# the patches kernel sizes its bands of output rows so that a launch has
# about this many blocks (4 an SM of an H100)
TARGET_BLOCKS = 4 * 132
# the epilogue's indices are int32
_MAX_ELEMS = 2**31 - 4 * THREADS


def bireal_patches_plain(x: torch.Tensor, stride: int) -> torch.Tensor:
    """The plain version: pack ``x >= 0`` into words, then gather the 3x3
    patches (B, Ho*Wo, 9*Cw)."""
    patches = extract_patch_words(pack_bits(x >= 0), stride)
    return patches.reshape(x.shape[0], -1, patches.shape[-1])


def bireal_epilogue_plain(acc, corr, scale, shift, res) -> torch.Tensor:
    """The plain version: ``addcmul(shift, float(acc + corr), scale)``,
    seen as `res`'s shape, ``add_(res)``."""
    y = torch.addcmul(shift, (acc + corr).to(REAL_DTYPE), scale)
    return y.view(res.shape).add_(res)


def patch_smem_bytes(w: int, cw: int, band_rows: int, stride: int) -> int:
    """Shared memory of a band: the word offset table and the band's
    padded sign words."""
    return 4 * (9 * cw + ((band_rows - 1) * stride + 3) * (w + 2) * cw)


def patch_band_rows(b: int, h: int, w: int, c: int, stride: int) -> int:
    """Output rows a block of the patches kernel owns: about
    ``TARGET_BLOCKS`` blocks in all, within ``SMEM_MAX``."""
    ho = strided_side(h, stride)
    cw = packed_len(c)
    bands = max(1, min(ho, -(-TARGET_BLOCKS // b)))
    rows = -(-ho // bands)
    while rows > 1 and patch_smem_bytes(w, cw, rows, stride) > SMEM_MAX:
        rows -= 1
    if patch_smem_bytes(w, cw, rows, stride) > SMEM_MAX:
        raise ValueError(f"bireal_patches_cuda: a row of {w} x {c} takes "
                         f"more than {SMEM_MAX} bytes of shared memory")
    return rows


_lib = None


def _library():
    global _lib
    if _lib is None:
        _lib = build.load_library("bireal_unit")
    return _lib


def _launch(entry, dev: torch.device, *args) -> None:
    """Launch `entry` on the current stream of `dev`; raise on an error."""
    if dev.index == torch.cuda.current_device():
        rc = entry(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = entry(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        build.check(_library(), "bireal_unit", rc)


def _on_card(name: str, t: torch.Tensor) -> bool:
    """Whether `t` takes the kernel (a CUDA tensor) or the plain version
    (a CPU tensor); raise for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def bireal_patches_cuda(x: torch.Tensor, stride: int) -> torch.Tensor:
    """float32 (B, H, W, C) -> int32 (B, Ho*Wo, 9*Cw) at `stride` (1 or
    2), ``bireal_patches_plain``'s words."""
    if not _on_card("bireal_patches_cuda", x):
        return bireal_patches_plain(x, stride)
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"bireal_patches_cuda takes a contiguous float32 "
                         f"(B, H, W, C), got {x.dtype} {tuple(x.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"bireal_patches_cuda: stride {stride}")
    b, h, w, c = x.shape
    ho, wo = strided_side(h, stride), strided_side(w, stride)
    out = torch.empty((b, ho * wo, 9 * packed_len(c)), dtype=torch.int32,
                      device=x.device)
    if out.numel() == 0:
        return out
    rows = patch_band_rows(b, h, w, c, stride)
    _launch(_library().bireal_patches_launch, x.device, x.data_ptr(),
            out.data_ptr(), b, h, w, c, stride, rows)
    bireal_patches_cuda.launches += 1
    return out


def bireal_epilogue_cuda(acc, corr, scale, shift, res) -> torch.Tensor:
    """acc (B, P, N) int32, corr (P, N) int32, scale and shift (N) float32,
    res (B, Ho, Wo, N) float32 with Ho*Wo = P -> float32 like `res`,
    ``bireal_epilogue_plain``'s values to the bit."""
    if not _on_card("bireal_epilogue_cuda", acc):
        return bireal_epilogue_plain(acc, corr, scale, shift, res)
    ops = (acc, corr, scale, shift, res)
    if any(t.device != acc.device for t in ops):
        raise ValueError("bireal_epilogue_cuda: operands on "
                         f"{[str(t.device) for t in ops]}")
    b, p, n = acc.shape
    if (acc.dtype != torch.int32 or corr.dtype != torch.int32
            or any(t.dtype != torch.float32 for t in ops[2:])
            or tuple(corr.shape) != (p, n) or tuple(scale.shape) != (n,)
            or tuple(shift.shape) != (n,) or res.dim() != 4
            or res.shape[0] != b or res.shape[1] * res.shape[2] != p
            or res.shape[3] != n or not all(t.is_contiguous() for t in ops)):
        raise ValueError(
            "bireal_epilogue_cuda takes contiguous acc (B,P,N) and corr (P,N) "
            "int32, scale and shift (N) and res (B,Ho,Wo,N) float32, got "
            f"{[(t.dtype, tuple(t.shape)) for t in ops]}")
    out = torch.empty(res.shape, dtype=torch.float32, device=res.device)
    if out.numel() == 0:
        return out
    if out.numel() > _MAX_ELEMS:
        raise ValueError(f"bireal_epilogue_cuda: {out.numel()} outputs "
                         f"outgrow int32 indices")
    ptrs = [t.data_ptr() for t in ops] + [out.data_ptr()]
    vec = n % 4 == 0 and all(q % 16 == 0 for q in ptrs)
    _launch(_library().bireal_epilogue_launch, acc.device, *ptrs,
            out.numel(), p * n, n, int(vec))
    bireal_epilogue_cuda.launches += 1
    return out


bireal_patches_cuda.launches = 0
bireal_epilogue_cuda.launches = 0

UNIT_KERNELS = (bireal_patches_cuda, bireal_epilogue_cuda)
