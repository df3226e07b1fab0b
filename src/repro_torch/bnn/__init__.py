"""The paper's BNNs on torch tensors: packed inference, and the fp-sim
forward with the straight-through estimator that trains them
(``layers``' fp-sim half, ``train``).

Conventions of the packed domain (shared with kernels/ and core/):
  * A binary value is conceptually in {-1, +1}; the stored bit is 1 for +1
    and 0 for -1.
  * Packed tensors are int32 with 32 bits packed along the LAST axis,
    least-significant bit first.
  * Activation words pad their tail lanes with bit 0, weight words with
    bit 1, so xnor tail lanes are always 0 and popcount counts only true
    lanes; `dot = 2 * popcount(xnor) - K_true` is then exact.
  * Integer (pre-activation) tensors are int32.
"""

from repro_torch.bnn.binarize import PACK_W, pack_bits, unpack_bits
from repro_torch.bnn.layers import LayerSpec, parse_notation
from repro_torch.bnn.models import (
    CIFAR10_NOTATION,
    FASHION_MNIST_NOTATION,
    BNNModel,
    build_model,
)

__all__ = [
    "PACK_W",
    "pack_bits",
    "unpack_bits",
    "LayerSpec",
    "parse_notation",
    "CIFAR10_NOTATION",
    "FASHION_MNIST_NOTATION",
    "BNNModel",
    "build_model",
]
