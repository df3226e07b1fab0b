"""Operations and bytes of both paper networks against counts worked by
hand from their layer shapes."""

import json
from pathlib import Path

import pytest

from hepbench import roofline
from hepbench.reference.bnn import parse

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _layers(name):
    c = json.loads((CONFIGS / f"{name}.json").read_text())
    return parse(c["notation"], c["input_hw"], c["in_channels"],
                 c["n_classes"])


# 1-bit products per image: H x W x Cout x 9 Cin per conv, Din x Dout per fc
CIFAR_PRODUCTS = (
    32 * 32 * 64 * 27          # C64 on 32x32x3
    + 32 * 32 * 64 * 576       # C64 on 32x32x64
    + 16 * 16 * 256 * 576      # C256 on 16x16x64
    + 16 * 16 * 256 * 2304     # C256 on 16x16x256
    + 8 * 8 * 512 * 2304       # C512 on 8x8x256
    + 8 * 8 * 512 * 4608       # C512 on 8x8x512
    + 8192 * 1024              # FC1024 on 4x4x512
    + 1024 * 10                # the last FC, to 10 classes
)
FMNIST_PRODUCTS = (
    28 * 28 * 64 * 9           # C64 on 28x28x1
    + 14 * 14 * 64 * 576       # C64 on 14x14x64
    + 3136 * 2048              # FC2048 on 7x7x64
    + 2048 * 10
)


def test_products_and_operations_by_hand():
    assert CIFAR_PRODUCTS == 463_153_152
    assert FMNIST_PRODUCTS == 14_119_936
    cifar, fmnist = _layers("cifar10-fused"), _layers("fmnist-dp")
    assert roofline.products(cifar) == CIFAR_PRODUCTS
    assert roofline.operations(cifar) == 2 * CIFAR_PRODUCTS
    assert roofline.products(fmnist) == FMNIST_PRODUCTS
    assert roofline.operations(fmnist) == 2 * FMNIST_PRODUCTS


def test_bytes_of_the_fused_cifar_span_by_hand():
    # layers 1-17 at 16 rows: 1,024 packed input words and 1,024 int32
    # outputs an image; packed weights (Cout x 9 x ceil(Cin / 32) words,
    # Dout x ceil(Din / 32)) and 5 bytes a step channel
    weights = 4 * (64 * 9 * 1 + 64 * 9 * 2 + 256 * 9 * 2 + 256 * 9 * 8
                   + 512 * 9 * 8 + 512 * 9 * 16 + 1024 * 256)
    steps = 5 * (64 + 64 + 256 + 256 + 512 + 512)
    want = 16 * 4 * (1024 + 1024) + weights + steps
    assert want == 1_729_408
    assert roofline.launch_bytes(_layers("cifar10-fused"), 0, 17, 16) == want
    # layer 19 alone: 32 packed words in, 10 int32 out, 10 x 32 words
    assert roofline.launch_bytes(_layers("cifar10-fused"), 18, 19, 16) == (
        16 * 4 * (32 + 10) + 4 * 10 * 32)


def test_bytes_of_one_fmnist_conv_by_hand():
    # C64 on 14x14x64: 14 x 14 x 2 packed words in, 14 x 14 x 64 out
    want = 16 * 4 * (14 * 14 * 2 + 14 * 14 * 64) + 4 * 64 * 9 * 2
    assert roofline.launch_bytes(_layers("fmnist-dp"), 3, 4, 16) == want


def test_launch_bound_is_the_larger_time():
    layers = _layers("cifar10-fused")
    ops_s = 16 * CIFAR_PRODUCTS / roofline.B1_PRODUCTS_PER_S
    bytes_s = 16 * 4 * 2048 / roofline.HBM_BYTES_PER_S
    got = roofline.launch_bound_s(layers, 0, 19, 16)
    assert got == pytest.approx(max(
        ops_s, roofline.launch_bytes(layers, 0, 19, 16)
        / roofline.HBM_BYTES_PER_S))
    assert got > bytes_s


def test_frozen_peaks():
    assert roofline.B1_PRODUCTS_PER_S == (
        16384 * 132 * roofline.MAX_SM_CLOCK_HZ)
    assert roofline.B1_OPS_PER_S == 2 * roofline.B1_PRODUCTS_PER_S
    assert roofline.HBM_BYTES_PER_S == 3.35e12
