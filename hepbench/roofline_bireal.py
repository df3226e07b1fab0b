"""Frozen peaks of one NVIDIA H100 SXM and the work of a Bi-Real network,
for kernel 1's roofline share in the ``bireal`` family and the whole
step's MFU.

Peaks (constants: nothing measured in a run feeds them):

* HBM, the 1-bit tensor-core rate: ``roofline.py``'s, restated here so
  that this file reads no ``hepbnn`` layer (a test holds them equal);
* the real layers' rate: 67e12 FLOP/s, NVIDIA's data sheet for the H100
  SXM, FP32 on the CUDA cores (the program's real layers run in float32
  with TF32 off).

Counting, from the reference's layers (``hepbench/reference/bireal.py``,
``Layer.products`` and ``Layer.real_macs``):

* a unit's binary conv: its 1-bit products at the true K (9 x Cin) and
  stride; operations are 2 x products;
* real work: the stem's 7x7 conv, the three projecting shortcuts' 1x1
  convs and the classifier, in multiply-adds; FLOPs are 2 x those.

A unit's launch of kernel 1 at `rows` padded rows is bounded by the
larger of its operations over the 1-bit rate and its bytes over HBM,
the bytes being the layer's input sign words read once (not the 9x
patches the eager gather hands the kernel, so that a gather inside the
kernel is judged on the same count), its packed weights, and its int32
output.
"""

from __future__ import annotations


HBM_BYTES_PER_S = 3.35e12
B1_PRODUCTS_PER_SM_PER_CLOCK = 16384
SMS = 132
MAX_SM_CLOCK_HZ = 1.98e9
B1_PRODUCTS_PER_S = B1_PRODUCTS_PER_SM_PER_CLOCK * SMS * MAX_SM_CLOCK_HZ
B1_OPS_PER_S = 2 * B1_PRODUCTS_PER_S
REAL_FLOPS_PER_S = 67e12
WORD = 32


def products(layers) -> int:
    """1-bit products per image of every unit's binary conv."""
    return sum(layer.products for layer in layers)


def real_macs(layers) -> int:
    """Real multiply-adds per image."""
    return sum(layer.real_macs for layer in layers)


def image_bound_s(layers) -> float:
    """The least time the card could spend on one image: its binary
    operations at the 1-bit rate plus its real FLOPs at the real rate."""
    return (2 * products(layers) / B1_OPS_PER_S
            + 2 * real_macs(layers) / REAL_FLOPS_PER_S)


def unit_launch_bytes(layer, rows: int) -> int:
    """Bytes of one unit's kernel-1 launch at `rows` images."""
    h, w, cin = layer.in_shape
    ho, wo, cout = layer.out_shape
    words = -(-cin // WORD)
    return 4 * (rows * (h * w * words + ho * wo * cout) + cout * 9 * words)


def unit_launch_bound_s(layer, rows: int) -> float:
    """The least time the card could take for one unit's launch."""
    return max(2 * rows * layer.products / B1_OPS_PER_S,
               unit_launch_bytes(layer, rows) / HBM_BYTES_PER_S)


def units(layers) -> list:
    """Indices of the network's Bi-Real units."""
    return [i for i, layer in enumerate(layers) if layer.kind == "bireal"]

