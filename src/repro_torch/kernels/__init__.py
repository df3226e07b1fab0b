"""Hand-written CUDA kernels for Hopper and their plain versions.

* ``xnor_popcount`` — ``xnor_gemm_cuda``, the BNN binary GEMM (conv as
  GEMM and FC) with the paper's X/Y/Z aspects as grid dimensions
  (``csrc/xnor_gemm.cu``).
* ``segment_fused`` — ``segment_cuda``, a whole device segment in one
  launch (``csrc/segment_fused.cu``).
* ``flash_attention`` — ``flash_attention_cuda``, blockwise
  online-softmax attention for LM prefill (``csrc/flash_attention.cu``),
  with its blockwise plain version ``flash_attention_plain``.
* ``ref`` — the plain PyTorch versions, which are also the paper's CPU
  implementation, and the naive ``attention_ref``.
* ``ops`` — the public entry points ``xnor_gemm``, ``binary_conv2d`` and
  ``flash_attention`` with a ``backend`` switch.
* ``build`` — compiles ``csrc/*.cu`` with ``nvcc`` at first use.
* ``registry`` — the variant registry the profiler and executors
  resolve config names through.

Each wrapper keeps a plain integer count of its launches
(``xnor_gemm_cuda.launches``, ``segment_cuda.launches``,
``flash_attention_cuda.launches``; of the last, the launches that also
write the log-sum-exp in ``flash_attention_cuda.lse_launches``).
"""

from repro_torch.kernels.registry import (
    DEFAULT_REGISTRY,
    GemmShape,
    KernelVariant,
    VariantRegistry,
    get_variant,
    register,
)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.ops import binary_conv2d, flash_attention, xnor_gemm
from repro_torch.kernels.segment_fused import segment_cuda
from repro_torch.kernels.xnor_popcount import xnor_gemm_cuda

KERNELS = (xnor_gemm_cuda, segment_cuda, flash_attention_cuda)


def launch_counts() -> dict:
    """{wrapper name: launches so far}."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    flash_attention_cuda.lse_launches = 0


__all__ = [
    "DEFAULT_REGISTRY",
    "GemmShape",
    "KERNELS",
    "KernelVariant",
    "VariantRegistry",
    "binary_conv2d",
    "flash_attention",
    "flash_attention_cuda",
    "get_variant",
    "launch_counts",
    "register",
    "reset_launch_counts",
    "segment_cuda",
    "xnor_gemm",
    "xnor_gemm_cuda",
]
