"""Hand-written CUDA kernels for Hopper and their plain versions.

* ``xnor_popcount`` — ``xnor_gemm_cuda``, the BNN binary GEMM (conv as
  GEMM and FC) with the paper's X/Y/Z aspects as grid dimensions
  (``csrc/xnor_gemm.cu``).
* ``segment_fused`` — ``segment_cuda``, a whole device segment in one
  launch (``csrc/segment_fused.cu``).
* ``ref`` — the plain PyTorch versions, which are also the paper's CPU
  implementation.
* ``build`` — compiles ``csrc/*.cu`` with ``nvcc`` at first use.
* ``registry`` — the variant registry the profiler and executors
  resolve config names through.

Each wrapper keeps a plain integer count of its launches
(``xnor_gemm_cuda.launches``, ``segment_cuda.launches``).
"""

from repro_torch.kernels.registry import (
    DEFAULT_REGISTRY,
    GemmShape,
    KernelVariant,
    VariantRegistry,
    get_variant,
    register,
)
from repro_torch.kernels.segment_fused import segment_cuda
from repro_torch.kernels.xnor_popcount import xnor_gemm_cuda

KERNELS = (xnor_gemm_cuda, segment_cuda)


def launch_counts() -> dict:
    """{wrapper name: launches so far}."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "DEFAULT_REGISTRY",
    "GemmShape",
    "KERNELS",
    "KernelVariant",
    "VariantRegistry",
    "get_variant",
    "launch_counts",
    "register",
    "reset_launch_counts",
    "segment_cuda",
    "xnor_gemm_cuda",
]
