"""Frozen peaks of one NVIDIA H100 SXM and the operations and bytes of a
BNN launch, for the kernels' roofline shares and the whole step's MFU.

Peaks (constants: nothing measured in a run feeds them):

* HBM: 3.35e12 bytes/s, NVIDIA's data sheet for the H100 SXM (80 GB
  HBM3).
* 1-bit tensor-core rate: B1_PRODUCTS_PER_SM_PER_CLOCK x SMS x
  MAX_SM_CLOCK_HZ bit-products a second.  16,384 bit-products per SM per
  clock is NVIDIA's published A100 binary rate worked back to one SM
  (4,992 TOPS = 2 x 16,384 x 108 SMs x 1.41 GHz); the H100 keeps the
  per-SM 1-bit rate of the A100.  A register-only m16n8k256 AND/popc
  probe on the card read 15,901 products per SM per clock, 97 % of it.
  132 SMs; MAX_SM_CLOCK_HZ is ``nvidia-smi --query-gpu=clocks.max.sm``
  read once on the card.  If a probe ever reads above this rate, the
  constant is wrong: raise it to the probe's reading once and freeze it.

Counting (per launch, at the rows it was given):

* operations are 2 x the 1-bit products of its conv and fc layers, with
  the true reduction length K (9 x Cin or Din), not padded to words;
* bytes count each input word read once and each output word written
  once: the activations entering the launch (packed words, or int32
  pre-activations where a step or pool starts it), each layer's packed
  weights and its thresholds (int32) and flips (one byte), and what the
  launch writes (int32 pre-activations after a conv or fc, packed words
  after a step or flatten).

A launch's bound is the larger of operations over the 1-bit rate and
bytes over the HBM rate.  The layers a launch computes decide its bound,
whichever kernel computes them.
"""

from __future__ import annotations

import math
from typing import Sequence

from hepbench.reference.bnn import Layer

HBM_BYTES_PER_S = 3.35e12
B1_PRODUCTS_PER_SM_PER_CLOCK = 16384
SMS = 132
MAX_SM_CLOCK_HZ = 1.98e9
B1_PRODUCTS_PER_S = B1_PRODUCTS_PER_SM_PER_CLOCK * SMS * MAX_SM_CLOCK_HZ
#: the same rate in operations (a product and an add each)
B1_OPS_PER_S = 2 * B1_PRODUCTS_PER_S

PACKED, UNPACKED = "packed", "unpacked"
WORD = 32


def encodings(layers: Sequence[Layer]) -> list:
    """(input encoding, output encoding) of every layer: the network's
    input arrives packed; conv and fc write int32, step and flatten
    write packed words, a pool keeps what it was given."""
    enc, out = PACKED, []
    for layer in layers:
        if layer.kind in ("conv", "fc"):
            nxt = UNPACKED
        elif layer.kind in ("step", "flat"):
            nxt = PACKED
        else:
            nxt = enc
        out.append((enc, nxt))
        enc = nxt
    return out


def elements(shape: tuple, encoding: str) -> int:
    """32-bit elements of one image's activation of logical `shape`."""
    if encoding == UNPACKED:
        return math.prod(shape)
    return math.prod(shape[:-1]) * -(-shape[-1] // WORD)


def param_bytes(layer: Layer) -> int:
    if layer.kind == "conv":
        return layer.units * 9 * -(-layer.in_shape[-1] // WORD) * 4
    if layer.kind == "fc":
        return layer.units * -(-layer.in_shape[0] // WORD) * 4
    if layer.kind == "step":
        return layer.units * (4 + 1)
    return 0


def products(layers: Sequence[Layer], start: int = 0,
             stop: int | None = None) -> int:
    """1-bit products per image of layers [start, stop)."""
    return sum(layer.products for layer in layers[start:stop])


def operations(layers: Sequence[Layer], start: int = 0,
               stop: int | None = None) -> int:
    return 2 * products(layers, start, stop)


def launch_bytes(layers: Sequence[Layer], start: int, stop: int,
                 rows: int) -> int:
    """Bytes of one launch computing layers [start, stop) for `rows`
    images."""
    enc = encodings(layers)
    first, last = layers[start], layers[stop - 1]
    act = (elements(first.in_shape, enc[start][0])
           + elements(last.out_shape, enc[stop - 1][1]))
    return 4 * rows * act + sum(param_bytes(x) for x in layers[start:stop])


def launch_bound_s(layers: Sequence[Layer], start: int, stop: int,
                   rows: int) -> float:
    """The least time the card could take for the launch."""
    return max(rows * products(layers, start, stop) / B1_PRODUCTS_PER_S,
               launch_bytes(layers, start, stop, rows) / HBM_BYTES_PER_S)
