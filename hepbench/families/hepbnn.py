"""The ``hepbnn`` family: the paper's BNNs in its ``C``/``MP``/``S``/
``FLAT``/``FC`` notation (HEP-BNN Tables I and II).

A configuration of this family (a configuration file without a
``"family"`` key) states ``notation``, ``input_hw``, ``in_channels``,
``n_classes``, ``bn_eps``, ``model`` and the planner's knobs
(``batch_sizes``, ``policy``, ``fuse``, ``max_wait_s`` and optionally
``configs``).  Its net is the reference's layer list, its weights and
images come from ``hepbench/inputs.py``, its requests are the images'
packed words, and its answers are int32 class scores that have to equal
the plain reference's (``hepbench/reference/bnn.py``) exactly: every sum
is an exact integer on both sides.
"""

from __future__ import annotations

import time

import numpy as np

from hepbench import inputs as seeded
from hepbench.harness import Program, log
from hepbench.reference import bnn as ref

# each counting wrapper of the port that serves this family, and its
# CUDA kernel as the profiler names it
KERNELS = {"xnor_gemm_cuda": "xnor_gemm_kernel",
           "segment_cuda": "segment_kernel"}
PACK_ROWS = 512


def inputs(config: dict, seed_weights: int, seed_images: int, device,
           pool: int) -> tuple:
    """(the reference's layers, fp weights, `pool` images) of a
    configuration, made on `device` from the seeds."""
    layers = ref.parse(config["notation"], config["input_hw"],
                       config["in_channels"], config["n_classes"])
    fp = seeded.fp_weights(layers, seed_weights, device)
    shape = tuple(config["input_hw"]) + (config["in_channels"],)
    return layers, fp, seeded.images(shape, pool, seed_images, device)


def payloads(x01) -> np.ndarray:
    """The packed words of every image, as the client submits them."""
    from repro_torch.bnn.models import prepare_input_packed

    return np.concatenate([
        prepare_input_packed(x01[i:i + PACK_ROWS]).cpu().numpy()
        for i in range(0, x01.shape[0], PACK_ROWS)])


def build_program(config: dict, fp_params: list, x01, device,
                  store: str) -> Program:
    """The port's set-up: pack, plan through the facade, serve."""
    from repro_torch import api
    from repro_torch.bnn.layers import parse_notation
    from repro_torch.bnn.models import BNNModel, pack_params

    hw, cin, ncls = (tuple(config["input_hw"]), config["in_channels"],
                     config["n_classes"])
    specs = tuple(parse_notation(config["notation"], hw, cin, ncls))
    model = BNNModel(config["model"], specs, hw, cin, ncls)
    t = [time.monotonic()]
    packed = pack_params(specs, fp_params, device=device)
    words = payloads(x01)
    t.append(time.monotonic())
    configs = config.get("configs")     # the mapper's candidates
    dep = api.Deployment.plan(
        (model, packed), batch_sizes=tuple(config["batch_sizes"]),
        policy=config["policy"], fuse=config["fuse"], store=store,
        configs=None if configs is None else tuple(configs), device=device,
    )
    t.append(time.monotonic())
    dep.serve(max_wait_s=config["max_wait_s"])
    t.append(time.monotonic())
    log("program set-up: " + ", ".join(
        f"{name} {b - a:.3f} s" for name, a, b in
        zip(("pack", "plan", "serve"), t, t[1:])))
    served = dep.configuration()
    return Program(dep, served, words, tuple(sorted(config["batch_sizes"])))


def expected(config: dict, layers: list, fp_params: list, x01, *,
             control: bool = False) -> np.ndarray:
    """The reference's int64 class scores of every image; ``control=True``
    evaluates every batch norm in bfloat16 instead of against its exact
    threshold."""
    return ref.forward(layers, fp_params, x01, eps=config["bn_eps"],
                       control=control).cpu().numpy()


def agree(config: dict, answers: np.ndarray, want: np.ndarray) -> tuple:
    """(answers equal to their expected rows, the checks): exact
    equality, and no wrong answer allowed."""
    ok = np.all(answers == want, axis=1)
    return ok, {"wrong_answers": (int(np.sum(~ok)), 0)}
