"""The plain reference of a Bi-Real network: the layer equations of Liu et
al., "Bi-Real Net", ECCV 2018 (arXiv:1808.00278), §3 and Fig. 1-2, in
float64 PyTorch, written from the configuration's notation alone.

It takes the uint8 images and the fp weights as drawn (conv weights HWIO,
(kh, kw, Cin, Cout); batch norms as gamma, beta, mean, var), binarizes,
scales and normalizes them itself, and imports nothing but torch and
numpy, so it takes nothing the program under test has made.

Semantics, for a (H, W, 3) uint8 image:

* ``STEM<c>``: ``x = (u8 / 255 - mean) / std`` (ImageNet's per-channel
  statistics), a 7x7 stride-2 conv with zero padding 3 and no bias, then
  batch norm;
* ``MPR<h>``: 3x3 stride-2 max pool, padding 1;
* ``BR<c>`` and ``BR<c>/2``: ``BN(alpha * conv3x3(sign(x), sign(W))) +
  shortcut(x)``, zero padding 1 (a padded tap adds 0), ``alpha`` the
  per-output-channel mean of ``|W|``; the shortcut is the identity, or,
  where the stride or the width changes, a 2x2 average pool, a 1x1 conv
  (no bias) and batch norm;
* ``GAP``: global average pool; ``FCR<n>``: ``x @ W + b``, the last one
  to the class count.

One departure from the authors' code: ``sign(0) = +1`` for weights and
activations, where ``torch.sign`` gives 0.  Random data never holds an
exact 0.

The binary convs' sums are integers below 2**24: they are computed in
float32 with TF32 off and rounded to the nearest integer, which makes
them exact whatever algorithm cuDNN picks (a Winograd transform leaves
them off by far less than 0.5, TF32 by more), and carried on in float64;
everything else is float64.  The images go through in blocks of
BLOCK_ROWS on their own device.  ``control=True`` is the control: every
batch norm, every shortcut add and the residual stream between layers
in bfloat16.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

BLOCK_ROWS = 64
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class Layer:
    kind: str          # stem | mpr | bireal | gap | fcr
    in_shape: tuple    # per-image logical shape, (H, W, C) or (C,)
    out_shape: tuple
    units: int = 0     # output channels or classes
    stride: int = 1    # a unit's

    @property
    def projects(self) -> bool:
        """A unit whose shortcut is pool + 1x1 conv + batch norm."""
        return self.kind == "bireal" and (
            self.stride != 1 or self.in_shape[-1] != self.units)

    @property
    def products(self) -> int:
        """1-bit products per image of a unit's conv, true K and stride."""
        if self.kind != "bireal":
            return 0
        h, w, c = self.out_shape
        return h * w * c * 9 * self.in_shape[-1]

    @property
    def real_macs(self) -> int:
        """Real multiply-adds per image: the stem's conv, a projecting
        shortcut's 1x1 conv, the classifier."""
        if self.kind == "stem":
            h, w, c = self.out_shape
            return h * w * c * 49 * self.in_shape[-1]
        if self.projects:
            h, w, c = self.out_shape
            return h * w * c * self.in_shape[-1]
        if self.kind == "fcr":
            return self.in_shape[0] * self.units
        return 0


def _side(n: int, stride: int) -> int:
    return (n - 1) // stride + 1


def parse(notation: Sequence[str], input_hw, in_channels: int,
          n_classes: int) -> list:
    """The network's layers from its notation."""
    last_fc = max(i for i, t in enumerate(notation) if t.startswith("FCR"))
    shape = (int(input_hw[0]), int(input_hw[1]), int(in_channels))
    layers = []
    for i, tok in enumerate(notation):
        if m := re.fullmatch(r"STEM(\d+)", tok):
            c = int(m.group(1))
            layer = Layer("stem", shape, (_side(shape[0], 2),
                                          _side(shape[1], 2), c), c)
        elif m := re.fullmatch(r"MPR(\d+)", tok):
            out = (_side(shape[0], 2), _side(shape[1], 2), shape[2])
            if out[0] != int(m.group(1)):
                raise ValueError(f"{tok}: a 3x3/2 pool of {shape} gives {out}")
            layer = Layer("mpr", shape, out, shape[2])
        elif m := re.fullmatch(r"BR(\d+)(?:/(\d+))?", tok):
            c, s = int(m.group(1)), int(m.group(2) or 1)
            layer = Layer("bireal", shape, (_side(shape[0], s),
                                            _side(shape[1], s), c), c, s)
        elif tok == "GAP":
            layer = Layer("gap", shape, (shape[-1],), shape[-1])
        elif m := re.fullmatch(r"FCR(\d+)", tok):
            n = n_classes if i == last_fc else int(m.group(1))
            layer = Layer("fcr", (int(np.prod(shape)),), (n,), n)
        else:
            raise ValueError(f"unknown layer {tok!r}")
        layers.append(layer)
        shape = layer.out_shape
    return layers


def _sign(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, -1.0).to(torch.float32)


def _nchw_weight(w: torch.Tensor, dtype) -> torch.Tensor:
    """(kh, kw, Cin, Cout) or (Cin, Cout) -> OIHW."""
    if w.dim() == 2:
        w = w[None, None]
    return w.permute(3, 2, 0, 1).to(dtype).contiguous()


def _bn(y: torch.Tensor, p: dict, prefix: str, eps: float,
        low: bool) -> torch.Tensor:
    """Batch norm of an NCHW `y` in float64, or in bfloat16 (control)."""
    dt = torch.bfloat16 if low else torch.float64
    g, b, m, v = (p[prefix + k].to(y.device, dt)[:, None, None]
                  for k in ("gamma", "beta", "mean", "var"))
    return (y.to(dt) - m) * torch.rsqrt(v + eps) * g + b


class _Prepared:
    """Each layer's weights on the images' device: float64 real convs,
    float32 sign(W), alpha."""

    def __init__(self, layers, params, device):
        self.w = []
        for layer, p in zip(layers, params):
            q = {}
            if layer.kind == "stem":
                q["w"] = _nchw_weight(p["w"].to(device), torch.float64)
            elif layer.kind == "bireal":
                w = p["w"].to(device, torch.float64)
                q["sign"] = _nchw_weight(_sign(w), torch.float32)
                q["alpha"] = w.abs().mean(dim=(0, 1, 2))[:, None, None]
                if layer.projects:
                    q["sc"] = _nchw_weight(p["sc_w"].to(device),
                                           torch.float64)
            elif layer.kind == "fcr":
                q["w"] = p["w"].to(device, torch.float64)
                q["b"] = p["b"].to(device, torch.float64)
            self.w.append(q)


def binary_sums(x: torch.Tensor, sign_w: torch.Tensor,
                stride: int) -> torch.Tensor:
    """``conv3x3(sign(x), sign(W))`` of an NCHW `x`, zero padding 1, as
    float64 integers: a float32 conv (TF32 off) rounded to the nearest
    integer, exact for every sum below 2**24."""
    y = F.conv2d(_sign(x), sign_w, stride=stride, padding=1)
    return torch.round(y).to(torch.float64)


def _layer(layer, p, q, x, eps, low):
    """One layer on an NCHW block (the stem takes the float image)."""
    stream = torch.bfloat16 if low else torch.float64
    if layer.kind == "stem":
        y = F.conv2d(x, q["w"], stride=2, padding=3)
        return _bn(y, p, "", eps, low).to(stream)
    if layer.kind == "mpr":
        return F.max_pool2d(x, 3, 2, 1)
    if layer.kind == "bireal":
        y = q["alpha"] * binary_sums(x, q["sign"], layer.stride)
        y = _bn(y, p, "", eps, low)
        if layer.projects:
            s = F.conv2d(F.avg_pool2d(x.to(torch.float64), 2, 2), q["sc"])
            s = _bn(s, p, "sc_", eps, low)
        else:
            s = x
        return (y.to(stream) + s.to(stream)).to(stream)
    if layer.kind == "gap":
        return x.to(torch.float64).mean(dim=(2, 3))
    return x.to(torch.float64) @ q["w"] + q["b"]          # fcr


def normalize(u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float64 NCHW, ``(u8 / 255 - mean) / std``."""
    x = u8.to(torch.float64).permute(0, 3, 1, 2) / 255.0
    mean = torch.tensor(MEAN, dtype=torch.float64, device=u8.device)
    std = torch.tensor(STD, dtype=torch.float64, device=u8.device)
    return (x - mean[:, None, None]) / std[:, None, None]


def forward(layers: Sequence[Layer], params: Sequence[dict], images, *,
            eps: float, control: bool = False,
            block: int = BLOCK_ROWS) -> torch.Tensor:
    """float64 logits (N, classes) of the uint8 images (N, H, W, 3), on
    the images' device, in blocks of `block`; ``control=True`` runs the
    batch norms, shortcut adds and residual stream in bfloat16."""
    prepared = _Prepared(layers, params, images.device)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = []
        with torch.no_grad():
            for i in range(0, images.shape[0], block):
                x = normalize(images[i:i + block])
                for layer, p, q in zip(layers, params, prepared.w):
                    x = _layer(layer, p, q, x, eps, control)
                out.append(x.to(torch.float64))
        return torch.cat(out)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
