"""BNN layer specs, parameter init, fp-sim (training) and packed-integer
(inference) per-layer implementations.

Two execution domains:

* **fp-sim** (training): values are float32 in {-1,+1} between layers,
  integers-as-floats for pre-activations; weights are latent fp32
  binarized on the forward pass with the straight-through estimator.
  Plain PyTorch (``F.conv2d``, ``@``) on +-1 operands, as the JAX
  package composes it from XLA.
* **packed** (inference): binary tensors are bit-packed int32 words
  (see ``repro_torch.bnn.binarize``); pre-activations are int32; step
  layers use batch-norm folded into integer thresholds
  (``repro_torch.bnn.fold_bn``).

The packed per-layer functions here are the **CPU implementation** in the
paper's sense — the sequential reference.  The parallel X/Y/Z
configurations are the CUDA kernels in ``repro_torch.kernels``, selected
per layer by the HEP mapper.  Every op keeps the JAX package's layouts:
activations (B, H, W, C) channels-last, fp conv weights (3, 3, Cin, Cout)
HWIO, fp fc weights (Din, Dout), packed conv weights (Cout, 9*Cw) in
tap-major order.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.bnn.binarize import PACK_W, binarize, binarize_ste, pack_bits

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Static description of one layer in paper notation."""

    idx: int            # 1-based position, as in the paper's tables
    kind: str           # 'conv' | 'mp' | 'step' | 'flat' | 'fc'
    notation: str       # e.g. 'C64', 'MP16', 'S', 'FLAT', 'FC1024'
    in_shape: tuple     # per-example logical shape (no batch), unpacked
    out_shape: tuple    # per-example logical shape (no batch), unpacked
    # conv/fc: number of output units; step: channel count
    units: int = 0

    @property
    def reduce_dim(self) -> int:
        """Reduction length K for conv (9*Cin) / fc (Din)."""
        if self.kind == "conv":
            return 9 * self.in_shape[-1]
        if self.kind == "fc":
            return int(np.prod(self.in_shape))
        return 0


def parse_notation(
    notation: Sequence[str],
    input_hw: tuple,
    in_channels: int,
    n_classes: int,
) -> list[LayerSpec]:
    """Build LayerSpecs from paper notation.

    The final FC layer maps its input to ``n_classes`` (the paper's
    trailing '-> 10'); every other FCx maps to x units. Convs are 3x3,
    SAME (pad value -1); maxpool is 2x2/2 with MPx asserting output x.
    """
    specs: list[LayerSpec] = []
    h, w = input_hw
    shape: tuple = (h, w, in_channels)
    last_fc = max(
        i for i, s in enumerate(notation) if s.startswith("FC")
    )
    for i, token in enumerate(notation):
        idx = i + 1
        if m := re.fullmatch(r"C(\d+)", token):
            cout = int(m.group(1))
            out = (shape[0], shape[1], cout)
            specs.append(LayerSpec(idx, "conv", token, shape, out, cout))
        elif m := re.fullmatch(r"MP(\d+)", token):
            tgt = int(m.group(1))
            out = (shape[0] // 2, shape[1] // 2, shape[2])
            if out[0] != tgt:
                raise ValueError(
                    f"{token} at layer {idx}: 2x2 pool of {shape} gives "
                    f"{out[0]}, expected {tgt}"
                )
            specs.append(LayerSpec(idx, "mp", token, shape, out, shape[2]))
        elif token == "S":
            specs.append(
                LayerSpec(idx, "step", token, shape, shape, shape[-1])
            )
        elif token == "FLAT":
            out = (int(np.prod(shape)),)
            specs.append(LayerSpec(idx, "flat", token, shape, out))
        elif m := re.fullmatch(r"FC(\d+)", token):
            din = int(np.prod(shape))
            dout = n_classes if i == last_fc else int(m.group(1))
            specs.append(LayerSpec(idx, "fc", token, (din,), (dout,), dout))
        else:
            raise ValueError(f"unknown layer token {token!r}")
        shape = specs[-1].out_shape
    return specs


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_bnn_params(
    generator: torch.Generator, specs: Sequence[LayerSpec], device
) -> list[dict]:
    """One dict per layer on `device`, drawn from `generator` (on its
    own device).  Trainable: conv/fc 'w' (latent fp32, uniform in
    +-1/sqrt(K)), step 'gamma'/'beta'.  State: step 'mean'/'var'
    (running stats)."""
    def uniform(shape, scale):
        w = torch.empty(shape, dtype=torch.float32, device=generator.device)
        return w.uniform_(-scale, scale, generator=generator).to(device)

    params: list[dict] = []
    for spec in specs:
        if spec.kind == "conv":
            cin = spec.in_shape[-1]
            params.append({"w": uniform((3, 3, cin, spec.units),
                                        1.0 / np.sqrt(9 * cin))})
        elif spec.kind == "fc":
            din = spec.in_shape[0]
            params.append({"w": uniform((din, spec.units),
                                        1.0 / np.sqrt(din))})
        elif spec.kind == "step":
            c = spec.units
            params.append({
                "gamma": torch.ones(c, device=device),
                "beta": torch.zeros(c, device=device),
                "mean": torch.zeros(c, device=device),
                "var": torch.ones(c, device=device),
            })
        else:
            params.append({})
    return params


TRAINABLE_KEYS = {"w", "gamma", "beta"}


def split_trainable(params: list[dict]) -> tuple[list[dict], list[dict]]:
    train = [
        {k: v for k, v in p.items() if k in TRAINABLE_KEYS} for p in params
    ]
    state = [
        {k: v for k, v in p.items() if k not in TRAINABLE_KEYS}
        for p in params
    ]
    return train, state


def merge_params(train: list[dict], state: list[dict]) -> list[dict]:
    return [dict(**t, **s) for t, s in zip(train, state)]


# ---------------------------------------------------------------------------
# fp-sim (training) per-layer forwards
# ---------------------------------------------------------------------------


def conv_fp(x: torch.Tensor, w_latent: torch.Tensor) -> torch.Tensor:
    """3x3 SAME binary conv on {-1,+1} inputs (B,H,W,C); pad value -1
    (the binary domain has no zero), then a VALID conv.  Output is
    integer-valued float32 (B,H,W,Cout).  The NHWC input seen as NCHW is
    a channels-last tensor, which cuDNN takes without a copy."""
    wb = binarize_ste(w_latent)                       # (3,3,Cin,Cout)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=-1.0)
    y = F.conv2d(xp.permute(0, 3, 1, 2), wb.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def maxpool_fp(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool as a reshape and ``amax``: like the JAX package's
    ``max``, ``amax`` splits the gradient evenly among tied maxima
    (``F.max_pool2d`` would give it all to one)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def step_fp(
    x: torch.Tensor, p: dict, *, train: bool
) -> tuple[torch.Tensor, dict]:
    """Batch norm + binary activation (Hard-Tanh STE).  Returns output
    and updated running-stat dict.  In train mode the gradient flows
    through the batch mean and (population) variance; the running-stat
    update takes them detached."""
    axes = tuple(range(x.ndim - 1))
    if train:
        mean = x.mean(dim=axes)
        var = x.var(dim=axes, correction=0)
        m, v = mean.detach(), var.detach()
        new_state = {
            "mean": (1 - BN_MOMENTUM) * p["mean"] + BN_MOMENTUM * m,
            "var": (1 - BN_MOMENTUM) * p["var"] + BN_MOMENTUM * v,
        }
    else:
        mean, var = p["mean"], p["var"]
        new_state = {"mean": p["mean"], "var": p["var"]}
    y = (x - mean) * torch.rsqrt(var + BN_EPS) * p["gamma"] + p["beta"]
    return binarize_ste(y), new_state


def fc_fp(x: torch.Tensor, w_latent: torch.Tensor) -> torch.Tensor:
    return x @ binarize_ste(w_latent)


def forward_fp(
    specs: Sequence[LayerSpec],
    params: list[dict],
    x_pm1: torch.Tensor,
    *,
    train: bool = False,
) -> tuple[torch.Tensor, list[dict]]:
    """Full fp-sim forward on a {-1,+1} input batch (B,H,W,C).  Returns
    (logits, params-with-updated-bn-state)."""
    new_params = []
    x = x_pm1
    for spec, p in zip(specs, params):
        if spec.kind == "conv":
            x = conv_fp(x, p["w"])
            new_params.append(p)
        elif spec.kind == "mp":
            x = maxpool_fp(x)
            new_params.append(p)
        elif spec.kind == "step":
            x, new_state = step_fp(x, p, train=train)
            new_params.append({**p, **new_state})
        elif spec.kind == "flat":
            x = x.reshape(x.shape[0], -1)
            new_params.append(p)
        elif spec.kind == "fc":
            x = fc_fp(x, p["w"])
            new_params.append(p)
    return x, new_params


def binarize_input(x01: torch.Tensor) -> torch.Tensor:
    """Map images in [0,1] to {-1,+1} (threshold 0.5)."""
    return binarize(x01 - 0.5)


# ---------------------------------------------------------------------------
# Packed-integer (inference) per-layer forwards — the 'CPU' implementation
# ---------------------------------------------------------------------------


def extract_patch_words(x_words: torch.Tensor) -> torch.Tensor:
    """(B,H,W,Cw) packed -> (B,H,W,9*Cw) 3x3 SAME patches, tap-major
    (word ``(dy*3+dx)*Cw + w``).  Spatial pad words are 0 == all -1
    pixels (the binary-domain pad value)."""
    b, h, w, cw = x_words.shape
    xp = F.pad(x_words, (0, 0, 1, 1, 1, 1))
    offs = [
        xp[:, dy : dy + h, dx : dx + w, :]
        for dy in range(3)
        for dx in range(3)
    ]
    return torch.cat(offs, dim=-1)


def conv_packed(
    x_words: torch.Tensor, w_words: torch.Tensor, k_true: int
) -> torch.Tensor:
    """Packed binary conv. x_words (B,H,W,Cw); w_words (Cout, 9*Cw);
    output int32 (B,H,W,Cout) with exact {-1,+1} conv values."""
    from repro_torch.kernels.ref import xnor_gemm_ref

    b, h, w, _ = x_words.shape
    patches = extract_patch_words(x_words).reshape(b, h * w, -1)
    return xnor_gemm_ref(patches, w_words, k_true).reshape(b, h, w, -1)


def maxpool_packed(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def step_packed(
    x_int: torch.Tensor, thresh: torch.Tensor, flip: torch.Tensor
) -> torch.Tensor:
    """int32 pre-activations -> packed bits via per-channel integer
    threshold: bit = (x > T) ^ flip."""
    return pack_bits((x_int > thresh) ^ flip)


def flat_packed(x_words: torch.Tensor, channels: int) -> torch.Tensor:
    """(B,h,w,Cw) -> (B, h*w*Cw). Requires channels % 32 == 0 so no tail
    lanes interleave (true for all paper models at the FLAT position)."""
    if channels % PACK_W != 0:
        raise ValueError("flatten of packed words needs C % 32 == 0")
    return x_words.reshape(x_words.shape[0], -1)


def fc_packed(
    x_words: torch.Tensor, w_words: torch.Tensor, k_true: int
) -> torch.Tensor:
    """Packed binary FC. x (B, Kw); w (Dout, Kw); out int32 (B, Dout)."""
    from repro_torch.kernels.ref import xnor_gemm_ref

    return xnor_gemm_ref(x_words[:, None, :], w_words, k_true)[:, 0, :]
