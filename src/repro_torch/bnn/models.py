"""Paper BNN models (Tables I & II), Bi-Real Net-18 + packed-inference
parameter preparation.

`build_model` returns a :class:`BNNModel` whose `specs` drive both the
fp-sim training forward and the per-layer packed inference used by the
HEP mapper.  Weights cross between the JAX package and this one as
NumPy arrays: fp weights into :func:`fp_params_from_numpy` (to train or
evaluate) or :func:`pack_params`, already-packed parameters into
:func:`packed_params_from_numpy`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence

import numpy as np
import torch

from repro_torch.bnn import layers as L
from repro_torch.bnn.binarize import np_pack_bits, pack_bits
from repro_torch.bnn.fold_bn import fold_bn
from repro_torch.device import resolve_device

# Table II — FashionMNIST BNN (10 layers)
FASHION_MNIST_NOTATION = (
    "C64", "MP14", "S", "C64", "MP7", "S", "FLAT", "FC2048", "S", "FC2048",
)
# Table I — CIFAR-10 BNN (19 layers)
CIFAR10_NOTATION = (
    "C64", "S", "C64", "MP16", "S", "C256", "S", "C256", "MP8", "S",
    "C512", "S", "C512", "MP4", "S", "FLAT", "FC1024", "S", "FC1024",
)



def bireal_notation(
    widths: Sequence[int] = (64, 128, 256, 512),
    blocks: Sequence[int] = (4, 4, 4, 4),
    input_hw: tuple = (224, 224),
) -> tuple:
    """Bi-Real Net in this notation (Liu et al., ECCV 2018, Fig. 1-2):
    the real stem and its 3x3/2 pool, ``blocks[s]`` units of width
    ``widths[s]`` per stage, the first of every stage but the first at
    stride 2, then the global average pool and the real classifier.
    The defaults are Bi-Real Net-18 at ImageNet's 224x224."""
    from repro_torch.bnn.layers import strided_side

    pooled = strided_side(strided_side(input_hw[0], 2), 2)
    out = [f"STEM{widths[0]}", f"MPR{pooled}"]
    for s, (c, n) in enumerate(zip(widths, blocks)):
        out += [f"BR{c}/2" if s and not k else f"BR{c}" for k in range(n)]
    return tuple(out + ["GAP", "FCR1000"])


# Bi-Real Net-18 (20 layers: 16 units)
BIREAL18_NOTATION = bireal_notation()


@dataclasses.dataclass(frozen=True)
class BNNModel:
    name: str
    specs: tuple
    input_hw: tuple
    in_channels: int
    n_classes: int

    def init(self, generator: torch.Generator, device=None) -> list[dict]:
        """Latent fp params drawn from `generator`, on `device`
        (``None`` -> ``cuda``)."""
        return L.init_bnn_params(generator, self.specs, resolve_device(device))

    def apply_fp(self, params, x01, *, train=False):
        """[0,1] images -> (logits, params with updated BN state), the
        fp-sim path."""
        L.require_binary_kinds([s.kind for s in self.specs], "BNN training")
        x = L.binarize_input(x01)
        return L.forward_fp(self.specs, params, x, train=train)

    @property
    def takes_images(self) -> bool:
        """Whether requests are uint8 images (a real stem first) rather
        than packed words."""
        return bool(self.specs) and self.specs[0].kind == "stem"


_REGISTRY = {
    "fashion_mnist": (FASHION_MNIST_NOTATION, (28, 28), 1, 10),
    "cifar10": (CIFAR10_NOTATION, (32, 32), 3, 10),
    "bireal18": (BIREAL18_NOTATION, (224, 224), 3, 1000),
}


def build_model(name: str, *, scale: float = 1.0) -> BNNModel:
    """Build a paper model. ``scale`` < 1 shrinks channel/unit counts
    (for smoke tests) while preserving the layer structure."""
    notation, hw, cin, ncls = _REGISTRY[name]
    if scale != 1.0:
        def shrink(tok: str) -> str:
            if m := re.fullmatch(r"(C|FC)(\d+)", tok):
                n = max(32, int(int(m.group(2)) * scale))
                n = (n // 32) * 32  # keep word-aligned
                return f"{m.group(1)}{n}"
            return tok
        notation = tuple(shrink(t) for t in notation)
    specs = tuple(L.parse_notation(notation, hw, cin, ncls))
    return BNNModel(name, specs, hw, cin, ncls)


def random_fp_params(specs: Sequence[L.LayerSpec], seed: int) -> list[dict]:
    """Random fp parameters from a NumPy seed, in the JAX package's
    layout (conv w (3,3,Cin,Cout), fc w (Din,Dout), step gamma/beta/
    mean/var).  BN statistics are scaled to each layer's pre-activation
    range and gamma takes both signs, so folded thresholds and flips
    split the bits rather than saturating them.  Real-valued layers get
    :func:`random_real_params`' draws."""
    rng = np.random.default_rng(seed)
    params: list[dict] = []
    k_prev = 1
    for spec in specs:
        if spec.kind in L.REAL_KINDS:
            params.append(random_real_params(spec, rng))
        elif spec.kind == "conv":
            cin = spec.in_shape[-1]
            s = 1.0 / np.sqrt(9 * cin)
            params.append({"w": rng.uniform(
                -s, s, (3, 3, cin, spec.units)).astype(np.float32)})
            k_prev = 9 * cin
        elif spec.kind == "fc":
            din = spec.in_shape[0]
            s = 1.0 / np.sqrt(din)
            params.append({"w": rng.uniform(
                -s, s, (din, spec.units)).astype(np.float32)})
            k_prev = din
        elif spec.kind == "step":
            c = spec.units
            sd = np.sqrt(k_prev)
            sign = rng.choice(np.array([-1.0, 1.0]), c)
            params.append({
                "gamma": (sign * rng.uniform(0.5, 1.5, c)).astype(
                    np.float32),
                "beta": rng.normal(0.0, 0.5, c).astype(np.float32),
                "mean": rng.normal(0.0, 0.25 * sd, c).astype(np.float32),
                "var": (sd**2 * rng.uniform(0.5, 1.5, c)).astype(
                    np.float32),
            })
        else:
            params.append({})
    return params


def _bn(rng, c: int, sd, prefix: str = "") -> dict:
    """Batch-norm parameters for a conv whose outputs spread by `sd`
    (scalar or per channel): statistics scaled to it, gamma of both
    signs."""
    sign = rng.choice(np.array([-1.0, 1.0]), c)
    return {
        prefix + "gamma": (sign * rng.uniform(0.5, 1.5, c)).astype(np.float32),
        prefix + "beta": rng.normal(0.0, 0.5, c).astype(np.float32),
        prefix + "mean": (0.25 * sd * rng.normal(0.0, 1.0, c)).astype(
            np.float32),
        prefix + "var": (sd**2 * rng.uniform(0.5, 1.5, c)).astype(np.float32),
    }


def random_real_params(spec: L.LayerSpec, rng) -> dict:
    """Random fp parameters of one real-valued layer, in the layout
    :func:`pack_params` takes: stem ``w`` (7,7,Cin,C) and its batch norm;
    a unit's latent ``w`` (3,3,Cin,Cout) and batch norm, and for a
    projecting shortcut ``sc_w`` (Cin,Cout) and ``sc_``-prefixed batch
    norm; fcr ``w`` (Din,Dout) and ``b``.  Weights are uniform in
    +-1/sqrt(K); each batch norm's statistics are scaled to its conv's
    output spread (``alpha * sqrt(K)`` for a unit's binary conv, 1/sqrt(3)
    for a real conv on unit-scale inputs), and the stem's shift sits
    below zero by what the max pool after it adds, so the residual
    stream's signs stay split."""
    if spec.kind == "stem":
        cin, c = spec.in_shape[-1], spec.units
        s = 1.0 / np.sqrt(49 * cin)
        w = rng.uniform(-s, s, (7, 7, cin, c)).astype(np.float32)
        p = {"w": w, **_bn(rng, c, 1.0 / np.sqrt(3.0))}
        # centred 1.5 |gamma| low, the mean of the largest of nine unit
        # normals, so that the 3x3 max pool after it keeps both signs
        p["beta"] = (p["beta"] - 1.5 * np.abs(p["gamma"])).astype(np.float32)
        return p
    if spec.kind == "bireal":
        cin, c = spec.in_shape[-1], spec.units
        k = 9 * cin
        w = rng.uniform(-1, 1, (3, 3, cin, c)).astype(np.float32) / np.sqrt(k)
        alpha = np.abs(w).mean(axis=(0, 1, 2))
        p = {"w": w, **_bn(rng, c, alpha * np.sqrt(k))}
        if spec.projects:
            s = 1.0 / np.sqrt(cin)
            p["sc_w"] = rng.uniform(-s, s, (cin, c)).astype(np.float32)
            p.update(_bn(rng, c, 1.0 / np.sqrt(3.0), "sc_"))
        return p
    if spec.kind == "fcr":
        din, dout = spec.in_shape[0], spec.units
        s = 1.0 / np.sqrt(din)
        return {"w": rng.uniform(-s, s, (din, dout)).astype(np.float32),
                "b": rng.normal(0.0, 0.1, dout).astype(np.float32)}
    return {}


def fp_params_from_numpy(params_np: list[dict], device=None) -> list[dict]:
    """fp params as NumPy (a list of dicts of arrays, e.g. the JAX
    package's params through ``np.asarray``, or :func:`random_fp_params`)
    -> this package's float32 tensors on `device` (``None`` -> ``cuda``),
    in the same layout."""
    dev = resolve_device(device)
    return [
        {k: torch.as_tensor(np.array(v, np.float32, order="C"), device=dev)
         for k, v in p.items()}
        for p in params_np
    ]


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


# ---------------------------------------------------------------------------
# Packed-inference parameter preparation
# ---------------------------------------------------------------------------


def pack_params(
    specs: Sequence[L.LayerSpec], params: list[dict], *, device=None
) -> list[dict]:
    """Quantize fp params (NumPy arrays or tensors on any device) into
    packed inference params on `device` (``None`` -> ``cuda``).

    conv:  w (3,3,Cin,Cout) -> words (Cout, 9*ceil(Cin/32)), tail bit 1
    fc:    w (Din,Dout)     -> words (Dout, ceil(Din/32)),   tail bit 1
    step:  gamma/beta/mean/var -> (thresh int32, flip bool) per channel

    Real-valued layers (:func:`pack_real`) keep float32 weights with each
    batch norm folded in, and a unit's sign words and padding correction.
    """
    packed: list[dict] = []
    for spec, p in zip(specs, params):
        if spec.kind in L.REAL_KINDS:
            packed.append(pack_real(spec, {k: _host(v) for k, v in p.items()}))
        elif spec.kind == "conv":
            w = _host(p["w"])                   # (3,3,Cin,Cout)
            cin, cout = w.shape[2], w.shape[3]
            # (Cout, 9, Cin): patch order must match extract_patch_words
            # (dy-major, dx-minor)
            wt = np.transpose(w, (3, 0, 1, 2)).reshape(cout, 9, cin)
            words = np_pack_bits(np.sign(wt) + 0.5, pad_bit=1)
            packed.append(
                {"w_words": words.reshape(cout, -1), "k_true": 9 * cin}
            )
        elif spec.kind == "fc":
            w = _host(p["w"])                   # (Din, Dout)
            words = np_pack_bits(np.sign(w.T) + 0.5, pad_bit=1)
            packed.append({"w_words": words, "k_true": w.shape[0]})
        elif spec.kind == "step":
            t, f = fold_bn(*(_host(p[k])
                             for k in ("gamma", "beta", "mean", "var")))
            packed.append({"thresh": t, "flip": f})
        else:
            packed.append({})
    return packed_params_from_numpy(packed, device)


def _fold_bn(p: dict, prefix: str = "", eps: float = L.BN_EPS) -> tuple:
    """(scale, shift) in float64 with ``BN(y) = scale * y + shift``."""
    g = p[prefix + "gamma"].astype(np.float64) / np.sqrt(
        p[prefix + "var"].astype(np.float64) + eps)
    return g, p[prefix + "beta"] - p[prefix + "mean"] * g


def padding_correction(signs: np.ndarray, hw: tuple, stride: int) -> np.ndarray:
    """The int32 table (Ho*Wo, Cout) a packed 3x3 conv adds to become the
    zero-padded conv: the packed pad reads -1, so at each output position
    each padded tap took ``-sum_cin sign(W)``; zero padding takes 0.
    `signs` is sign(W), (3,3,Cin,Cout) of +-1."""
    h, w = hw
    ho, wo = L.strided_side(h, stride), L.strided_side(w, stride)
    wsum = signs.sum(axis=2).astype(np.int64)           # (3, 3, Cout)
    corr = np.zeros((ho, wo, signs.shape[-1]), np.int64)
    for dy in range(3):
        rows = stride * np.arange(ho) + dy - 1
        for dx in range(3):
            cols = stride * np.arange(wo) + dx - 1
            padded = ((rows < 0) | (rows >= h))[:, None] | (
                (cols < 0) | (cols >= w))[None, :]
            corr += padded[:, :, None] * wsum[dy, dx]
    return corr.reshape(ho * wo, -1).astype(np.int32)


def pack_real(spec: L.LayerSpec, p: dict) -> dict:
    """Inference params of one real-valued layer from NumPy fp params
    (:func:`random_real_params`' layout), as NumPy: each batch norm and
    ``alpha`` folded in float64, the floats then rounded to float32."""
    f32 = np.float32
    if spec.kind == "stem":
        scale, shift = _fold_bn(p)
        w = np.transpose(p["w"].astype(np.float64) * scale, (3, 2, 0, 1))
        std = np.asarray(L.IMAGENET_STD, np.float64)
        return {"w": w.astype(f32), "b": shift.astype(f32),
                "in_scale": (1.0 / (255.0 * std)).astype(f32),
                "in_shift": (-np.asarray(L.IMAGENET_MEAN) / std).astype(f32)}
    if spec.kind == "bireal":
        w = p["w"]                                        # (3,3,Cin,Cout)
        cin, cout = w.shape[2], w.shape[3]
        signs = np.where(w >= 0, 1, -1)
        alpha = np.abs(w.astype(np.float64)).mean(axis=(0, 1, 2))
        scale, shift = _fold_bn(p)
        wt = np.transpose(signs, (3, 0, 1, 2)).reshape(cout, 9, cin)
        q = {"w_words": np_pack_bits(wt, pad_bit=1).reshape(cout, -1),
             "k_true": 9 * cin, "scale": (alpha * scale).astype(f32),
             "shift": shift.astype(f32),
             "corr": padding_correction(signs, spec.in_shape[:2],
                                        spec.stride)}
        if spec.projects:
            s_scale, s_shift = _fold_bn(p, "sc_")
            sc = (p["sc_w"].astype(np.float64) * s_scale).T
            q["sc_w"] = sc[:, :, None, None].astype(f32)
            q["sc_b"] = s_shift.astype(f32)
        return q
    if spec.kind == "fcr":
        return {"w": p["w"].astype(f32), "b": p["b"].astype(f32)}
    return {}


#: packed-param keys of a real-valued layer, which hold float32 (every
#: other tensor is int32 but ``flip``, bool)
FLOAT_KEYS = frozenset(
    ("w", "b", "scale", "shift", "sc_w", "sc_b", "in_scale", "in_shift"))


def packed_params_from_numpy(packed_np: list[dict], device=None) -> list[dict]:
    """Packed params as NumPy (``w_words`` int32, ``k_true`` int,
    ``thresh`` int32, ``flip`` bool — e.g. the JAX package's
    ``pack_params`` output through ``np.asarray``; a real-valued layer's
    ``FLOAT_KEYS`` float32) -> this package's tensors on `device`
    (``None`` -> ``cuda``)."""
    dev = resolve_device(device)
    out: list[dict] = []
    for p in packed_np:
        q = {}
        for k, v in p.items():
            if k == "k_true":
                q[k] = int(v)
            else:
                dtype = (bool if k == "flip" else
                         np.float32 if k in FLOAT_KEYS else np.int32)
                arr = np.array(v, dtype, order="C")
                q[k] = torch.as_tensor(arr, device=dev)
        out.append(q)
    return out


def params_to(packed: dict, device) -> dict:
    """One layer's packed params with every tensor on `device`."""
    return {
        k: v.to(device) if isinstance(v, torch.Tensor) else v
        for k, v in packed.items()
    }


def prepare_input_packed(x01: torch.Tensor) -> torch.Tensor:
    """[0,1] images (B,H,W,C) -> packed words (B,H,W,ceil(C/32)),
    threshold 0.5, ties -> +1."""
    return pack_bits(x01 - 0.5 >= 0)


def forward_packed(
    specs: Sequence[L.LayerSpec], packed: list[dict], x_words: torch.Tensor
) -> torch.Tensor:
    """Reference packed inference (the 'CPU' implementation end to end)
    on `x_words`' device.  Returns int32 class scores (float32 logits for
    a real-valued network, whose input is uint8 images)."""
    from repro_torch.kernels.ref import xnor_gemm_ref

    x = x_words
    for spec, p in zip(specs, packed):
        p = params_to(p, x.device)
        if spec.kind in L.REAL_KINDS:
            x = L.real_layer_fn(spec, p, xnor_gemm_ref)(x)
        elif spec.kind == "conv":
            x = L.conv_packed(x, p["w_words"], p["k_true"])
        elif spec.kind == "mp":
            x = L.maxpool_packed(x)
        elif spec.kind == "step":
            x = L.step_packed(x, p["thresh"], p["flip"])
        elif spec.kind == "flat":
            x = L.flat_packed(x, spec.in_shape[-1])
        elif spec.kind == "fc":
            x = L.fc_packed(x, p["w_words"], p["k_true"])
    return x
