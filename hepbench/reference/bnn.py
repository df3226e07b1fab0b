"""The plain reference of a HEP-BNN network: the paper's layer equations
in float PyTorch on ±1 values, written from the configuration's notation
alone.

It binarizes the images itself, binarizes the fp weights itself and
turns each batch norm + sign into a comparison with a float64 threshold
itself, so it takes nothing that the program under test has made.  It
imports nothing but torch and numpy.

Semantics (HEP-BNN Tables I and II):

* input: pixel ``>= 0.5`` is +1, else -1;
* ``C<n>``: 3x3 convolution, stride 1, SAME padding with the pad value
  -1 (the binary domain has no zero), weights ``sign(w)`` with
  ``sign(0) = +1``; pre-activations are exact integers;
* ``MP<n>``: 2x2 max pool, stride 2, on whatever it is given;
* ``S``: batch norm then sign, ``+1`` where
  ``gamma * (y - mean) / sqrt(var + eps) + beta >= 0``;
* ``FLAT``: row-major (h, w, c) flatten;
* ``FC<n>``: dense ``x @ sign(W)``; the last FC maps to the class count.

Every sum is an integer below 2**24, so float32 convolutions and matrix
products (TF32 off) are exact; the class scores come back as int64.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

BLOCK_ROWS = 512


@dataclasses.dataclass(frozen=True)
class Layer:
    kind: str          # conv | mp | step | flat | fc
    in_shape: tuple    # per-image logical shape
    out_shape: tuple
    units: int = 0     # conv/fc outputs, step channels

    @property
    def products(self) -> int:
        """1-bit products per image, with the true reduction length."""
        if self.kind == "conv":
            h, w, cin = self.in_shape
            return h * w * self.units * 9 * cin
        if self.kind == "fc":
            return self.in_shape[0] * self.units
        return 0


def parse(notation: Sequence[str], input_hw, in_channels: int,
          n_classes: int) -> list:
    """The network's layers from its notation."""
    last_fc = max(i for i, t in enumerate(notation) if t.startswith("FC"))
    shape = (int(input_hw[0]), int(input_hw[1]), int(in_channels))
    layers = []
    for i, tok in enumerate(notation):
        if m := re.fullmatch(r"C(\d+)", tok):
            n = int(m.group(1))
            layer = Layer("conv", shape, shape[:2] + (n,), n)
        elif m := re.fullmatch(r"MP(\d+)", tok):
            out = (shape[0] // 2, shape[1] // 2, shape[2])
            if out[0] != int(m.group(1)) or shape[0] % 2 or shape[1] % 2:
                raise ValueError(f"{tok}: a 2x2 pool of {shape} gives {out}")
            layer = Layer("mp", shape, out)
        elif tok == "S":
            layer = Layer("step", shape, shape, shape[-1])
        elif tok == "FLAT":
            layer = Layer("flat", shape, (int(np.prod(shape)),))
        elif m := re.fullmatch(r"FC(\d+)", tok):
            n = n_classes if i == last_fc else int(m.group(1))
            layer = Layer("fc", (int(np.prod(shape)),), (n,), n)
        else:
            raise ValueError(f"unknown layer {tok!r}")
        layers.append(layer)
        shape = layer.out_shape
    return layers


def thresholds(p: dict, eps: float) -> tuple:
    """(t, sign of gamma, beta >= 0) per channel, in float64 on the host:
    the sign fires where ``y >= t`` (gamma > 0) or ``y <= t`` (gamma <
    0); with gamma == 0 it is the sign of beta."""
    g, b, m, v = (np.asarray(p[k].detach().cpu().numpy(), np.float64)
                  for k in ("gamma", "beta", "mean", "var"))
    sd = np.sqrt(v + eps)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = m - b * sd / g
    return t, np.sign(g), b >= 0


def _sign(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, -1.0).to(torch.float32)


def _step_exact(y: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    t, sg, bpos = (torch.as_tensor(a, device=y.device)
                   for a in thresholds(p, eps))
    yd = y.to(torch.float64)
    fire = torch.where(sg > 0, yd >= t, torch.where(sg < 0, yd <= t, bpos))
    return torch.where(fire, 1.0, -1.0).to(torch.float32)


def _step_bf16(y: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    """The control: the same batch norm evaluated in bfloat16."""
    bf = torch.bfloat16
    g, b, m, v = (p[k].to(y.device, bf) for k in ("gamma", "beta", "mean",
                                                  "var"))
    z = (y.to(bf) - m) * torch.rsqrt(v + eps) * g + b
    return torch.where(z >= 0, 1.0, -1.0).to(torch.float32)


def forward(layers: Sequence[Layer], params: Sequence[dict], x01, *,
            eps: float, control: bool = False) -> torch.Tensor:
    """Class scores (N, classes) int64 of the images `x01` (N, H, W, C) in
    [0, 1), on `x01`'s device, in blocks of BLOCK_ROWS images.
    ``control=True`` evaluates every batch norm in bfloat16 instead of
    against its float64 threshold."""
    step = _step_bf16 if control else _step_exact
    wb = [_sign(p["w"].to(x01.device)) if "w" in p else None for p in params]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = []
        with torch.no_grad():
            for i in range(0, x01.shape[0], BLOCK_ROWS):
                x = _sign(x01[i:i + BLOCK_ROWS] - 0.5)
                for layer, p, w in zip(layers, params, wb):
                    x = _layer(layer, p, w, x, step, eps)
                out.append(torch.round(x).to(torch.int64))
        return torch.cat(out)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _layer(layer, p, w, x, step, eps):
    if layer.kind == "conv":
        xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=-1.0)       # NHWC
        y = F.conv2d(xp.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
        return y.permute(0, 2, 3, 1)
    if layer.kind == "mp":
        n, h, ww, c = x.shape
        return x.reshape(n, h // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))
    if layer.kind == "step":
        return step(x, p, eps)
    if layer.kind == "flat":
        return x.reshape(x.shape[0], -1)
    return x @ w                                             # fc
