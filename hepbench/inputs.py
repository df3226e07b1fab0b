"""Weights and images of a run, made on the device from ``--seed``.

The fp weights are drawn in two calls of one ``torch.Generator`` on the
run's device (all uniforms, then all normals) and cut into the layout
the paper's models use: conv ``w`` (3, 3, Cin, Cout), fc ``w`` (Din,
Dout), step ``gamma``, ``beta``, ``mean``, ``var`` (C,).  Conv and fc
weights are uniform in +-1/sqrt(K).  The batch-norm statistics are scaled
to the range of the pre-activations that feed them (sd = sqrt(K) of the
GEMM before), and gamma takes both signs, so the thresholds split the
bits instead of saturating them.  The images are one uniform [0, 1) draw.
Both sides of a run, the program and the reference, get these same
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from hepbench.reference.bnn import Layer


def seeds(seed: int, n: int) -> list:
    """`n` independent 63-bit seeds derived from the run's `seed`."""
    state = np.random.SeedSequence(int(seed)).generate_state(n, np.uint64)
    return [int(s) >> 1 for s in state]


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def fp_weights(layers: list, seed: int, device) -> list:
    """One dict of float32 tensors per layer (empty for mp and flat)."""
    n_uniform = n_normal = 0
    for layer in layers:
        if layer.kind in ("conv", "fc"):
            n_uniform += _weight_size(layer)
        elif layer.kind == "step":
            n_uniform += 3 * layer.units     # gamma size and sign, var
            n_normal += 2 * layer.units      # beta, mean
    gen = _generator(seed, device)
    u = torch.rand(n_uniform, generator=gen, device=device)
    z = torch.randn(max(n_normal, 1), generator=gen, device=device)
    params, iu, iz, k_prev = [], 0, 0, 1
    for layer in layers:
        if layer.kind in ("conv", "fc"):
            n = _weight_size(layer)
            k = layer.products // (layer.units * _rows(layer))
            shape = ((3, 3, layer.in_shape[-1], layer.units)
                     if layer.kind == "conv"
                     else (layer.in_shape[0], layer.units))
            w = (2 * u[iu:iu + n] - 1) / np.sqrt(k)
            params.append({"w": w.reshape(shape).contiguous()})
            iu += n
            k_prev = k
        elif layer.kind == "step":
            c = layer.units
            ug, us, uv = u[iu:iu + 3 * c].reshape(3, c)
            zb, zm = z[iz:iz + 2 * c].reshape(2, c)
            iu, iz = iu + 3 * c, iz + 2 * c
            sd = float(np.sqrt(k_prev))
            sign = torch.where(us < 0.5, -1.0, 1.0)
            params.append({
                "gamma": (sign * (0.5 + ug)).contiguous(),
                "beta": (0.5 * zb).contiguous(),
                "mean": (0.25 * sd * zm).contiguous(),
                "var": (sd * sd * (0.5 + uv)).contiguous(),
            })
        else:
            params.append({})
    return params


def _rows(layer: Layer) -> int:
    """Output rows of a GEMM layer per image (windows of a conv)."""
    return layer.in_shape[0] * layer.in_shape[1] if layer.kind == "conv" else 1


def _weight_size(layer: Layer) -> int:
    return layer.products // _rows(layer)


def images(shape: tuple, n: int, seed: int, device) -> torch.Tensor:
    """(n, H, W, C) float32 images, uniform in [0, 1)."""
    return torch.rand((n,) + tuple(shape), generator=_generator(seed, device),
                      device=device)
