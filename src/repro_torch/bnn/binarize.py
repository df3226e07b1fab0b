"""Bit-packing primitives on torch tensors.

Bit convention: bit 1 encodes +1, bit 0 encodes -1. Packing is along the
last axis, 32 values per int32 word, LSB first. Tail lanes (when the axis
length is not a multiple of 32) are padded with ``pad_bit``: activations
use 0, weights use 1, so that `xnor` tail lanes are identically 0 and
``2 * popcount(xnor(a, w)) - K`` equals the exact {-1,+1} dot product over
the K true lanes.

torch has no unsigned 32-bit arithmetic worth the name and no popcount,
and ``>>`` on int32 is arithmetic.  So every bit manipulation here runs
in int64 on the value masked to its low 32 bits, and words are wrapped
back to int32 explicitly (values >= 2**31 minus 2**32), never through an
out-of-range cast.
"""

from __future__ import annotations

import numpy as np
import torch

PACK_W = 32  # bits per packed word
_LOW32 = 0xFFFFFFFF


def binarize(x: torch.Tensor) -> torch.Tensor:
    """Hard sign into {-1, +1}; ties (x == 0) go to +1."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


class _BinarizeSTE(torch.autograd.Function):
    """Sign forward, clipped straight-through estimator backward: the
    gradient passes where |x| <= 1 (the Hard-Tanh STE of the paper's
    training recipe [Hubara et al. 2016])."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return binarize(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


def binarize_ste(x: torch.Tensor) -> torch.Tensor:
    """:func:`binarize` with the clipped STE as its gradient."""
    return _BinarizeSTE.apply(x)


def packed_len(n: int) -> int:
    return (n + PACK_W - 1) // PACK_W


def _wrap_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 with the same bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pack_bits(x: torch.Tensor, pad_bit: int = 0) -> torch.Tensor:
    """Pack a {-1,+1} (or boolean) tensor along the last axis into int32
    words.  Numeric inputs map ``x >= 0`` to bit 1 (ties -> +1)."""
    bits = x if x.dtype == torch.bool else x >= 0
    n = bits.shape[-1]
    n_words = packed_len(n)
    pad = n_words * PACK_W - n
    if pad:
        fill = torch.full(
            bits.shape[:-1] + (pad,), bool(pad_bit), device=bits.device
        )
        bits = torch.cat([bits, fill], dim=-1)
    bits = bits.reshape(bits.shape[:-1] + (n_words, PACK_W)).to(torch.int64)
    shifts = torch.arange(PACK_W, dtype=torch.int64, device=bits.device)
    return _wrap_int32((bits << shifts).sum(dim=-1))


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Unpack int32 words into a float32 {-1,+1} tensor of last-axis
    length ``n`` (tail lanes dropped)."""
    w = words.to(torch.int64) & _LOW32
    shifts = torch.arange(PACK_W, dtype=torch.int64, device=words.device)
    bits = (w[..., None] >> shifts) & 1
    flat = bits.reshape(bits.shape[:-2] + (bits.shape[-2] * PACK_W,))
    flat = flat[..., :n]
    return torch.where(flat == 1, 1.0, -1.0).to(torch.float32)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Population count of int32 words (SWAR on the low 32 bits in
    int64), result int32."""
    v = x.to(torch.int64) & _LOW32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = ((v * 0x01010101) & _LOW32) >> 24
    return v.to(torch.int32)


def xnor_dot_words(
    a_words: torch.Tensor, w_words: torch.Tensor, k_true: int
) -> torch.Tensor:
    """Exact {-1,+1} dot product of two packed vectors (last axis =
    words): ``2 * sum(popcount(~(a ^ w))) - k_true``.

    Relies on the tail-padding convention (a tail bit 0, w tail bit 1)
    making xnor tail lanes 0.
    """
    agree = popcount(~(a_words ^ w_words)).sum(dim=-1, dtype=torch.int32)
    return 2 * agree - k_true


def np_pack_bits(x: np.ndarray, pad_bit: int = 0) -> np.ndarray:
    """NumPy twin of pack_bits for host-side weight preparation."""
    bits = (x >= 0) if x.dtype != np.bool_ else x
    n = bits.shape[-1]
    n_words = packed_len(n)
    pad = n_words * PACK_W - n
    if pad:
        fill = np.full(bits.shape[:-1] + (pad,), bool(pad_bit))
        bits = np.concatenate([bits, fill], axis=-1)
    bits = bits.reshape(bits.shape[:-1] + (n_words, PACK_W)).astype(np.uint32)
    shifts = np.arange(PACK_W, dtype=np.uint32)
    words = np.sum(bits << shifts, axis=-1, dtype=np.uint64).astype(np.uint32)
    return words.view(np.int32).reshape(words.shape)
