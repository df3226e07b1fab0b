"""The ``bireal`` family: Bi-Real networks (Liu et al., ECCV 2018,
arXiv:1808.00278) on uint8 images, answered with float logits.

A configuration of this family states ``"family": "bireal"``,
``notation`` (``STEM``/``MPR``/``BR``/``GAP``/``FCR``, as
``repro_torch.bnn.layers`` reads it), ``input_hw``, ``in_channels``,
``n_classes``, ``bn_eps``, ``model``, ``tolerance``,
``max_wrong_share`` and the planner's knobs (``batch_sizes``,
``policy``, ``configs``, ``fuse``, ``max_wait_s``).  Its net is the
reference's layer list (``hepbench/reference/bireal.py``), its weights
and images are drawn here on the run's device from the seeds, its
requests are the uint8 images themselves, and its answers are float32
logits.

The agreement rule: for each answered row, the largest absolute
difference from the reference's float64 logits, relative to the row's
largest absolute reference logit; a row above the configuration's
``tolerance`` is wrong, and at most ``max_wrong_share`` of the answered
rows may be.  The program computes its real layers in float32.  In most
rows that keeps it within float32 rounding of the reference, far below
the tolerance.  In a few a value of the residual stream within rounding
of zero takes the other sign into the next binary conv, and the flip
cascades into a row error of up to a few percent, as in any float32
Bi-Real.  Those rows are a share of the images, not every image: the
bfloat16 control puts nearly every row above the tolerance.  So the
share of wrong rows, not each row, tells the two apart; the
configuration gives both limits' reasons and ``PERF.md`` the readings
they were set from.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hepbench.harness import Program, log
from hepbench.reference import bireal as ref

# the counting wrapper of the port that serves this family, and its CUDA
# kernel as the profiler names it
KERNELS = {"xnor_gemm_cuda": "xnor_gemm_kernel"}


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _sizes(layer) -> tuple:
    """(uniforms, normals) one layer draws."""
    cin, c = layer.in_shape[-1], layer.units
    bn = (3 * c, 2 * c)                 # gamma size and sign, var; beta, mean
    if layer.kind == "stem":
        return 49 * cin * c + bn[0], bn[1]
    if layer.kind == "bireal":
        u, z = 9 * cin * c + bn[0], bn[1]
        if layer.projects:
            u, z = u + cin * c + bn[0], z + bn[1]
        return u, z
    if layer.kind == "fcr":
        return layer.in_shape[0] * c, c
    return 0, 0


def _bn(u, z, c: int, sd) -> dict:
    """Batch norm from 3c uniforms and 2c normals, its statistics scaled
    to the conv's output spread `sd` (scalar or per channel), gamma of
    both signs."""
    ug, us, uv = u.reshape(3, c)
    zb, zm = z.reshape(2, c)
    return {"gamma": torch.where(us < 0.5, -1.0, 1.0) * (0.5 + ug),
            "beta": 0.5 * zb, "mean": 0.25 * sd * zm,
            "var": sd * sd * (0.5 + uv)}


def fp_weights(layers: list, seed: int, device) -> list:
    """One dict of float32 tensors per layer, drawn in two calls of one
    generator on `device` (all uniforms, then all normals).  Conv and fc
    weights are uniform in +-1/sqrt(K), layout (kh, kw, Cin, Cout) and
    (Din, Dout); a projecting shortcut's ``sc_w`` is (Cin, Cout) with
    ``sc_``-prefixed batch norm; fcr has a bias.  Each batch norm's
    statistics are scaled to its conv's output spread (``alpha *
    sqrt(K)`` for a unit's binary conv, 1/sqrt(3) for a real conv), and
    the stem's shift sits 1.5 |gamma| low, what the 3x3 max pool after it
    adds, so that the residual stream's signs stay split in every unit."""
    sizes = [_sizes(layer) for layer in layers]
    gen = _generator(seed, device)
    u = torch.rand(max(sum(s[0] for s in sizes), 1), generator=gen,
                   device=device)
    z = torch.randn(max(sum(s[1] for s in sizes), 1), generator=gen,
                    device=device)
    params, iu, iz = [], 0, 0

    def take_u(n):
        nonlocal iu
        iu += n
        return u[iu - n:iu]

    def take_z(n):
        nonlocal iz
        iz += n
        return z[iz - n:iz]

    real_sd = 1.0 / np.sqrt(3.0)
    for layer in layers:
        cin, c = layer.in_shape[-1], layer.units
        p = {}
        if layer.kind == "stem":
            k = 49 * cin
            p["w"] = ((2 * take_u(k * c) - 1) / np.sqrt(k)).reshape(
                7, 7, cin, c)
            p.update(_bn(take_u(3 * c), take_z(2 * c), c, real_sd))
            p["beta"] = p["beta"] - 1.5 * p["gamma"].abs()
        elif layer.kind == "bireal":
            k = 9 * cin
            w = ((2 * take_u(k * c) - 1) / np.sqrt(k)).reshape(3, 3, cin, c)
            sd = w.abs().mean(dim=(0, 1, 2)) * np.sqrt(k)
            p["w"] = w
            p.update(_bn(take_u(3 * c), take_z(2 * c), c, sd))
            if layer.projects:
                s = 1.0 / np.sqrt(cin)
                p["sc_w"] = ((2 * take_u(cin * c) - 1) * s).reshape(cin, c)
                bn = _bn(take_u(3 * c), take_z(2 * c), c, real_sd)
                p.update({"sc_" + key: v for key, v in bn.items()})
        elif layer.kind == "fcr":
            din = layer.in_shape[0]
            p["w"] = ((2 * take_u(din * c) - 1) / np.sqrt(din)).reshape(
                din, c)
            p["b"] = 0.1 * take_z(c)
        params.append({key: v.contiguous() for key, v in p.items()})
    return params


def inputs(config: dict, seed_weights: int, seed_images: int, device,
           pool: int) -> tuple:
    """(the reference's layers, fp weights, `pool` uint8 images (pool, H,
    W, C)) of a configuration, made on `device` from the seeds."""
    layers = ref.parse(config["notation"], config["input_hw"],
                       config["in_channels"], config["n_classes"])
    shape = (pool,) + tuple(config["input_hw"]) + (config["in_channels"],)
    images = torch.randint(0, 256, shape, generator=_generator(
        seed_images, device), device=device, dtype=torch.uint8)
    return layers, fp_weights(layers, seed_weights, device), images


def payloads(images) -> np.ndarray:
    """The uint8 images, as the client submits them."""
    return images.cpu().numpy()


def build_program(config: dict, fp_params: list, images, device,
                  store: str) -> Program:
    """The port's set-up: fold and pack, plan through the facade, serve."""
    from repro_torch import api
    from repro_torch.bnn.layers import parse_notation
    from repro_torch.bnn.models import BNNModel, pack_params

    hw, cin, ncls = (tuple(config["input_hw"]), config["in_channels"],
                     config["n_classes"])
    specs = tuple(parse_notation(config["notation"], hw, cin, ncls))
    model = BNNModel(config["model"], specs, hw, cin, ncls)
    t = [time.monotonic()]
    packed = pack_params(specs, fp_params, device=device)
    requests = payloads(images)
    t.append(time.monotonic())
    dep = api.Deployment.plan(
        (model, packed), batch_sizes=tuple(config["batch_sizes"]),
        policy=config["policy"], fuse=config["fuse"], store=store,
        configs=tuple(config["configs"]), device=device,
    )
    t.append(time.monotonic())
    dep.serve(max_wait_s=config["max_wait_s"])
    t.append(time.monotonic())
    log("program set-up: " + ", ".join(
        f"{name} {b - a:.3f} s" for name, a, b in
        zip(("pack", "plan", "serve"), t, t[1:])))
    return Program(dep, dep.configuration(), requests,
                   tuple(sorted(config["batch_sizes"])))


def expected(config: dict, layers: list, fp_params: list, images, *,
             control: bool = False) -> np.ndarray:
    """The reference's float64 logits of every image; ``control=True``
    runs its batch norms, shortcut adds and residual stream in
    bfloat16."""
    return ref.forward(layers, fp_params, images, eps=config["bn_eps"],
                       control=control).cpu().numpy()


def row_error(answers: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Per row: the largest absolute difference from the reference,
    over the row's largest absolute reference logit."""
    answers = np.asarray(answers, np.float64)
    return (np.max(np.abs(answers - want), axis=1)
            / np.max(np.abs(want), axis=1))


def agree(config: dict, answers: np.ndarray, want: np.ndarray) -> tuple:
    """(rows within the tolerance, the checks): the rows above it may be
    at most ``max_wrong_share`` of the answered rows."""
    ok = row_error(answers, want) <= config["tolerance"]  # NaN is wrong
    limit = int(config["max_wrong_share"] * ok.size)
    return ok, {"wrong_answers": (int(np.sum(~ok)), limit)}
