"""Paper BNN models (Tables I & II) + packed-inference parameter
preparation.

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
        x = L.binarize_input(x01)
        return L.forward_fp(self.specs, params, x, train=train)


_REGISTRY = {
    "fashion_mnist": (FASHION_MNIST_NOTATION, (28, 28), 1, 10),
    "cifar10": (CIFAR10_NOTATION, (32, 32), 3, 10),
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
    split the bits rather than saturating them."""
    rng = np.random.default_rng(seed)
    params: list[dict] = []
    k_prev = 1
    for spec in specs:
        if spec.kind == "conv":
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
    """
    packed: list[dict] = []
    for spec, p in zip(specs, params):
        if spec.kind == "conv":
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


def packed_params_from_numpy(packed_np: list[dict], device=None) -> list[dict]:
    """Packed params as NumPy (``w_words`` int32, ``k_true`` int,
    ``thresh`` int32, ``flip`` bool — e.g. the JAX package's
    ``pack_params`` output through ``np.asarray``) -> this package's
    tensors on `device` (``None`` -> ``cuda``)."""
    dev = resolve_device(device)
    out: list[dict] = []
    for p in packed_np:
        q = {}
        for k, v in p.items():
            if k == "k_true":
                q[k] = int(v)
            else:
                arr = np.array(v, bool if k == "flip" else np.int32, order="C")
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
    on `x_words`' device.  Returns int32 class scores."""
    x = x_words
    for spec, p in zip(specs, packed):
        p = params_to(p, x.device)
        if spec.kind == "conv":
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
