"""Plain float64 reference of a Bi-Real network for the CPU tests (Liu et
al., "Bi-Real Net", ECCV 2018, arXiv:1808.00278, §3 and Fig. 1-2),
written from the notation alone; it imports only torch and numpy.

Per layer, on a (H, W, 3) uint8 image:

* ``STEM<c>``: ``(u8 / 255 - mean) / std`` with ImageNet's statistics,
  7x7 stride-2 conv (zero padding 3, no bias), batch norm;
* ``MPR<h>``: 3x3 stride-2 max pool, padding 1;
* ``BR<c>[/2]``: ``BN(alpha * conv3x3(sign(x), sign(W))) + shortcut(x)``
  with zero padding 1, ``alpha`` the per-output-channel mean of ``|W|``,
  the shortcut the identity or (stride or width changing) 2x2 average
  pool, 1x1 conv and batch norm;
* ``GAP``; ``FCR<n>``: ``x @ W + b``, the last to the class count.

Departure from the authors' code: ``sign(0) = +1`` for weights and
activations (``torch.sign`` gives 0 there; random data never holds an
exact 0).  Everything is float64, so the binary convs' integer sums are
exact and the float parts sharper than the program's float32.  The
benchmark's copy (``hepbench/reference/bireal.py``) computes the same in
blocks on the run's device; a test holds the two equal.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
F64 = torch.float64


def _side(n, stride):
    return (n - 1) // stride + 1


def parse(notation, input_hw, in_channels, n_classes):
    """[(kind, in_shape, out_shape, units, stride)] of the notation."""
    last = max(i for i, t in enumerate(notation) if t.startswith("FCR"))
    shape = (input_hw[0], input_hw[1], in_channels)
    out = []
    for i, tok in enumerate(notation):
        if m := re.fullmatch(r"STEM(\d+)", tok):
            c = int(m.group(1))
            layer = ("stem", shape, (_side(shape[0], 2), _side(shape[1], 2), c),
                     c, 2)
        elif re.fullmatch(r"MPR\d+", tok):
            layer = ("mpr", shape, (_side(shape[0], 2), _side(shape[1], 2),
                                    shape[2]), shape[2], 2)
        elif m := re.fullmatch(r"BR(\d+)(?:/(\d+))?", tok):
            c, s = int(m.group(1)), int(m.group(2) or 1)
            layer = ("bireal", shape, (_side(shape[0], s), _side(shape[1], s),
                                       c), c, s)
        elif tok == "GAP":
            layer = ("gap", shape, (shape[-1],), shape[-1], 1)
        elif m := re.fullmatch(r"FCR(\d+)", tok):
            n = n_classes if i == last else int(m.group(1))
            layer = ("fcr", (int(np.prod(shape)),), (n,), n, 1)
        else:
            raise ValueError(tok)
        out.append(layer)
        shape = layer[2]
    return out


def sign(x):
    """+1 where x >= 0, else -1 (sign(0) = +1)."""
    return torch.where(torch.as_tensor(x) >= 0, 1.0, -1.0).to(F64)


def oihw(w):
    """(kh, kw, Cin, Cout) or (Cin, Cout) -> OIHW float64."""
    w = torch.as_tensor(np.asarray(w), dtype=F64)
    if w.dim() == 2:
        w = w[None, None]
    return w.permute(3, 2, 0, 1)


def bn(y, p, eps, prefix=""):
    """Batch norm of NCHW `y` in float64."""
    g, b, m, v = (torch.as_tensor(np.asarray(p[prefix + k]), dtype=F64)
                  [:, None, None] for k in ("gamma", "beta", "mean", "var"))
    return (y - m) / torch.sqrt(v + eps) * g + b


def binary_sums(x_nchw, w, stride):
    """conv3x3(sign(x), sign(W)), zero padding 1: exact integers."""
    return F.conv2d(sign(x_nchw), sign(oihw(w)), stride=stride, padding=1)


def layer_forward(layer, p, x, eps=1e-5):
    """One layer on NCHW float64 (the stem: on NHWC uint8)."""
    kind, in_shape, _, units, stride = layer
    if kind == "stem":
        x = torch.as_tensor(np.asarray(x)).to(F64).permute(0, 3, 1, 2) / 255.0
        x = (x - torch.tensor(MEAN, dtype=F64)[:, None, None]) / torch.tensor(
            STD, dtype=F64)[:, None, None]
        return bn(F.conv2d(x, oihw(p["w"]), stride=2, padding=3), p, eps)
    if kind == "mpr":
        return F.max_pool2d(x, 3, 2, 1)
    if kind == "bireal":
        w = torch.as_tensor(np.asarray(p["w"]), dtype=F64)
        alpha = w.abs().mean(dim=(0, 1, 2))[:, None, None]
        y = bn(alpha * binary_sums(x, w, stride), p, eps)
        if stride != 1 or in_shape[-1] != units:
            s = F.conv2d(F.avg_pool2d(x, 2, 2), oihw(p["sc_w"]))
            return y + bn(s, p, eps, "sc_")
        return y + x
    if kind == "gap":
        return x.mean(dim=(2, 3))
    return x @ torch.as_tensor(np.asarray(p["w"]), dtype=F64) + torch.as_tensor(
        np.asarray(p["b"]), dtype=F64)


def forward(layers, params, images_u8, eps=1e-5):
    """float64 logits (N, classes) of uint8 images (N, H, W, 3)."""
    x = images_u8
    for layer, p in zip(layers, params):
        x = layer_forward(layer, p, x, eps)
    return x
