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

**Real-valued layers** (Bi-Real Net, Liu et al., ECCV 2018, §3): a
network whose first layer is ``STEM<c>`` takes a uint8 image and keeps a
float32 residual stream between its layers; only the 3x3 conv of each
``BR<c>`` unit has binary operands.  Its kinds and their equations:

* ``STEM<c>`` (``stem``): ``(u8 / 255 - mean) / std`` with ImageNet's
  per-channel statistics, a 7x7 stride-2 conv (zero padding 3, no bias)
  and batch norm;
* ``MPR<h>`` (``mpr``): 3x3 stride-2 max pool, padding 1, output side h;
* ``BR<c>`` / ``BR<c>/2`` (``bireal``): ``BN(alpha * conv3x3(sign(x),
  sign(W))) + shortcut(x)`` at stride 1 or 2, zero padding 1, ``alpha``
  the per-output-channel mean of ``|W|``; the shortcut is the identity,
  or, where the stride or the width changes, a 2x2 average pool, a 1x1
  real conv and batch norm;
* ``GAP`` (``gap``): global average pool;
* ``FCR<n>`` (``fcr``): real dense layer with bias; the last one maps to
  the class count.

``sign(0) = +1`` for weights and activations, as everywhere here.  The
packed conv pads with -1 (pad word 0), so the unit adds a fixed int32
table, per output position and channel, of the padded taps' ±1 weights:
its sums are then those of the zero-padded conv, exactly.

The real layers, the residual stream and the logits are float32
(``REAL_DTYPE``), with TF32 off for the real convs on a card.  Against a
float64 forward the stream is not reproducible bit for bit: a value
within float32 rounding of 0 takes the other sign into the next binary
conv in some 6-10 % of ImageNet-size images, and the flip cascades
through the later units' signs into logit errors of up to a few
percent.  Any float32 Bi-Real does the same.
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

#: the packed grammar of the paper's networks; every other kind is
#: real-valued (Bi-Real Net)
BINARY_KINDS = ("conv", "mp", "step", "flat", "fc")
REAL_KINDS = ("stem", "mpr", "bireal", "gap", "fcr")
#: kinds whose computation is the xnor GEMM of a registry variant
GEMM_KINDS = ("conv", "fc", "bireal")
#: the type of a real-valued network's stream, real layers and logits
REAL_DTYPE = torch.float32
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Static description of one layer in paper notation."""

    idx: int            # 1-based position, as in the paper's tables
    kind: str           # BINARY_KINDS or REAL_KINDS
    notation: str       # e.g. 'C64', 'MP16', 'S', 'FLAT', 'FC1024', 'BR128/2'
    in_shape: tuple     # per-example logical shape (no batch), unpacked
    out_shape: tuple    # per-example logical shape (no batch), unpacked
    # conv/fc/stem/bireal/fcr: number of output units; step: channels
    units: int = 0

    @property
    def reduce_dim(self) -> int:
        """Reduction length K for conv and bireal (9*Cin) / fc (Din)."""
        if self.kind in ("conv", "bireal"):
            return 9 * self.in_shape[-1]
        if self.kind == "fc":
            return int(np.prod(self.in_shape))
        return 0

    @property
    def stride(self) -> int:
        """A Bi-Real unit's stride (``BR<c>/2``); 1 for every other."""
        m = re.fullmatch(r"BR\d+/(\d+)", self.notation)
        return int(m.group(1)) if m else 1

    @property
    def projects(self) -> bool:
        """Whether a Bi-Real unit's shortcut is pool + 1x1 conv + BN."""
        return self.kind == "bireal" and (
            self.stride != 1 or self.in_shape[-1] != self.units)


def strided_side(n: int, stride: int) -> int:
    """Output side of a 3x3 window at `stride` with padding 1 (also the
    7x7 stem's at stride 2 with padding 3)."""
    return (n - 1) // stride + 1


def require_binary_kinds(kinds, what: str) -> None:
    """Raise a ValueError naming the first layer kind outside the packed
    grammar: `what` handles only the paper's binary networks."""
    for i, kind in enumerate(kinds):
        if kind not in BINARY_KINDS:
            raise ValueError(
                f"{what} takes only the packed BNN layers {BINARY_KINDS}; "
                f"layer {i + 1} is {kind!r}, a real-valued layer")


def parse_notation(
    notation: Sequence[str],
    input_hw: tuple,
    in_channels: int,
    n_classes: int,
) -> list[LayerSpec]:
    """Build LayerSpecs from paper notation.

    The final FC (or FCR) layer maps its input to ``n_classes`` (the
    paper's trailing '-> 10'); every other FCx maps to x units. Convs are
    3x3, SAME (pad value -1); maxpool is 2x2/2 with MPx asserting output
    x.  The real-valued tokens (``STEM``, ``MPR``, ``BR``, ``GAP``,
    ``FCR``) are the module docstring's.
    """
    specs: list[LayerSpec] = []
    h, w = input_hw
    shape: tuple = (h, w, in_channels)
    last_fc = max(
        i for i, s in enumerate(notation) if s.startswith("FC")
    )
    for i, token in enumerate(notation):
        idx = i + 1
        if spec := _parse_real(idx, token, shape, i == last_fc, n_classes):
            specs.append(spec)
        elif m := re.fullmatch(r"C(\d+)", token):
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


def _parse_real(idx, token, shape, last_fc, n_classes):
    """The LayerSpec of a real-valued token, None for any other."""
    if m := re.fullmatch(r"STEM(\d+)", token):
        c = int(m.group(1))
        out = (strided_side(shape[0], 2), strided_side(shape[1], 2), c)
        return LayerSpec(idx, "stem", token, shape, out, c)
    if m := re.fullmatch(r"MPR(\d+)", token):
        out = (strided_side(shape[0], 2), strided_side(shape[1], 2),
               shape[2])
        if out[0] != int(m.group(1)):
            raise ValueError(f"{token} at layer {idx}: a 3x3/2 pool of "
                             f"{shape} gives {out[0]}")
        return LayerSpec(idx, "mpr", token, shape, out, shape[2])
    if m := re.fullmatch(r"BR(\d+)(?:/(\d+))?", token):
        c, stride = int(m.group(1)), int(m.group(2) or 1)
        if stride not in (1, 2):
            raise ValueError(f"{token} at layer {idx}: stride 1 or 2")
        out = (strided_side(shape[0], stride), strided_side(shape[1], stride),
               c)
        spec = LayerSpec(idx, "bireal", token, shape, out, c)
        if spec.projects and stride == 2 and (shape[0] % 2 or shape[1] % 2):
            raise ValueError(f"{token} at layer {idx}: the shortcut's 2x2 "
                             f"pool of odd {shape[:2]} misses the conv's "
                             f"{out[:2]}")
        return spec
    if token == "GAP":
        return LayerSpec(idx, "gap", token, shape, (shape[-1],), shape[-1])
    if m := re.fullmatch(r"FCR(\d+)", token):
        din = int(np.prod(shape))
        dout = n_classes if last_fc else int(m.group(1))
        return LayerSpec(idx, "fcr", token, (din,), (dout,), dout)
    return None


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
    require_binary_kinds([s.kind for s in specs], "BNN training")
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


def extract_patch_words(
    x_words: torch.Tensor, stride: int = 1
) -> torch.Tensor:
    """(B,H,W,Cw) packed -> (B,Ho,Wo,9*Cw) 3x3 patches with padding 1 at
    `stride` (SAME at 1), tap-major (word ``(dy*3+dx)*Cw + w``).  Spatial
    pad words are 0 == all -1 pixels (the binary-domain pad value)."""
    b, h, w, cw = x_words.shape
    ho, wo = strided_side(h, stride), strided_side(w, stride)
    xp = F.pad(x_words, (0, 0, 1, 1, 1, 1))
    offs = [
        xp[:, dy : dy + stride * (ho - 1) + 1 : stride,
           dx : dx + stride * (wo - 1) + 1 : stride, :]
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


# ---------------------------------------------------------------------------
# Real-valued (Bi-Real Net) per-layer forwards: one implementation for the
# host (CPU tensors, the plain xnor GEMM) and the card (CUDA tensors, a
# kernel-1 variant), chosen by the tensors' device and the GEMM given
# ---------------------------------------------------------------------------


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor seen as NCHW: channels-last, no copy."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def fp32_convs():
    """cuDNN with TF32 off for the block (by default it rounds float32
    conv operands to a 10-bit mantissa), every other cuDNN setting as the
    caller left it (``cudnn.flags`` sets each one it is given)."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def stem_real(x_u8: torch.Tensor, p: dict) -> torch.Tensor:
    """uint8 (B,H,W,3) -> float32 (B,Ho,Wo,C): normalize, 7x7/2 conv with
    the batch norm folded into its weights and bias."""
    x = x_u8.to(REAL_DTYPE) * p["in_scale"] + p["in_shift"]
    with fp32_convs():
        y = F.conv2d(_nchw(x), p["w"], p["b"], stride=2, padding=3)
    return _nhwc(y)


def maxpool_real(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max pool, padding 1 (the pad never wins)."""
    return _nhwc(F.max_pool2d(_nchw(x), 3, 2, 1))


def bireal_sums(
    x: torch.Tensor, p: dict, stride: int, gemm
) -> torch.Tensor:
    """A unit's binary conv: ``conv3x3(sign(x), sign(W))`` with zero
    padding, exact int32 (B, Ho*Wo, Cout): the packed GEMM `gemm` (a
    registry variant's builder) over the patches of the sign words
    (``x >= 0`` is bit 1), plus the padding correction."""
    from repro_torch.kernels.bireal_unit import bireal_patches_cuda

    acc = gemm(bireal_patches_cuda(x, stride), p["w_words"], p["k_true"])
    return acc + p["corr"]


def bireal_unit(x: torch.Tensor, p: dict, stride: int, gemm) -> torch.Tensor:
    """float32 (B,H,W,Cin) -> (B,Ho,Wo,Cout):
    ``scale * sums + shift + shortcut(x)``, with ``alpha`` and the batch
    norm folded into the per-channel ``scale`` and ``shift``.  On a card
    the sign pack and gather, and the epilogue, are one kernel each
    around `gemm` (``repro_torch.kernels.bireal_unit``); on the host the
    same wrappers run their plain versions."""
    from repro_torch.kernels.bireal_unit import (
        bireal_epilogue_cuda,
        bireal_patches_cuda,
    )

    acc = gemm(bireal_patches_cuda(x, stride), p["w_words"], p["k_true"])
    if "sc_w" not in p:
        res = x
    else:
        with fp32_convs():
            s = F.conv2d(F.avg_pool2d(_nchw(x), 2, 2), p["sc_w"], p["sc_b"])
        res = _nhwc(s)
    return bireal_epilogue_cuda(acc, p["corr"], p["scale"], p["shift"], res)


def gap_real(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(1, 2))


def fc_real(x: torch.Tensor, p: dict) -> torch.Tensor:
    """The classifier, float32 logits (a float32 matmul on a card follows
    ``torch.backends.cuda.matmul.allow_tf32``, False by default)."""
    return torch.addmm(p["b"], x, p["w"])


def real_layer_fn(spec: LayerSpec, p: dict, gemm=None):
    """The real-valued layer `spec` with its packed params `p` (already
    on the device the layer runs on); a unit's binary conv goes through
    `gemm` ``(a, w, k_true) -> out``."""
    if spec.kind == "stem":
        return lambda x: stem_real(x, p)
    if spec.kind == "mpr":
        return maxpool_real
    if spec.kind == "bireal":
        stride = spec.stride
        return lambda x: bireal_unit(x, p, stride, gemm)
    if spec.kind == "gap":
        return gap_real
    if spec.kind == "fcr":
        return lambda x: fc_real(x, p)
    raise ValueError(f"not a real-valued layer kind: {spec.kind!r}")
