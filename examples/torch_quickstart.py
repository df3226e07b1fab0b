"""Quickstart on PyTorch and CUDA (the port of ``examples/quickstart.py``):
train a small BNN with the STE recipe, quantize to bit-packed inference
form, let HEP-BNN map each layer to its fastest implementation on this
CPU + GPU machine, run the mapped model, and serve it through the
segment-pipelined engine.

    PYTHONPATH=src python examples/torch_quickstart.py             # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --smoke     # CI-sized
    PYTHONPATH=src python examples/torch_quickstart.py --smoke --device cpu

Device-placed layers run the hand-written CUDA kernels (the packed
xnor/popcount GEMM for conv and fc); ``--device cpu`` runs every layer
on CPU tensors.  Without ``--device`` it runs on the card and raises
when there is none.
"""

import argparse

import numpy as np
import torch

from repro_torch import api
from repro_torch.bnn import build_model
from repro_torch.bnn.models import (
    forward_packed, pack_params, prepare_input_packed,
)
from repro_torch.bnn.train import eval_step, init_train_state, train_step
from repro_torch.core import build_mapped_model
from repro_torch.core.mapper import best_uniform
from repro_torch.data import ShardedBatcher, make_image_dataset
from repro_torch.device import resolve_device
from repro_torch.kernels import launch_counts
from repro_torch.optim import adamw
from repro_torch.serving import ServingEngine

SEED = 0
LR = 2e-3


def _launched(before: dict) -> dict:
    """Kernel launches since `before` (a ``launch_counts()``)."""
    return {k: n - before[k] for k, n in launch_counts().items()}


def main(argv=None, *, state=None) -> dict:
    """Run the walkthrough; returns what it printed and checked: the
    model, ``state`` (trained), ``packed``, the ``table``, the DP and
    greedy configurations (``ec``, ``ec_greedy``), ``t_xyz`` and the
    µs/image of each policy, ``out`` / ``ref`` (the mapped model's and
    ``forward_packed``'s scores), ``served`` (the 8 answers),
    ``schedule`` and ``launches`` (kernel launches while profiling,
    running the mapped model and serving).

    `state` (keyword only): the ``TrainState`` to train from, in place of
    ``init_train_state`` from a generator seeded 0 (the tests carry the
    JAX package's initial state across)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="shrink model/steps/profiling for CI")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    scale = 0.25 if args.smoke else 0.5
    steps = 10 if args.smoke else 60
    batch_sizes = (1, 4) if args.smoke else (1, 4, 16)
    repeats = 1 if args.smoke else 2

    # 1. train (synthetic Fashion-MNIST stand-in — offline container)
    model = build_model("fashion_mnist", scale=scale)
    ds = make_image_dataset(0, 2048, model.input_hw, model.in_channels)
    if state is None:
        state, opt = init_train_state(
            model, torch.Generator(device=dev).manual_seed(SEED), lr=LR,
            device=dev)
    else:
        opt = adamw(LR)
    batcher = ShardedBatcher(n=2048, global_batch=64, seed=0)
    metrics = []
    for step in range(steps):
        x, y = batcher.batch((ds.x, ds.y), step)
        state, m = train_step(model, opt, state, x, y)
        metrics.append({k: float(v) for k, v in m.items()})
    xe, ye = batcher.batch((ds.x, ds.y), 9_999)
    acc = float(eval_step(model, state.params, xe, ye))
    print(f"eval acc after {steps} steps: {acc:.3f}")

    # 2. quantize -> packed xnor/popcount inference model
    packed = pack_params(model.specs, state.params, device=dev)

    # 3. HEP-BNN: profile every layer under all 8 implementations,
    #    then map with both policies — the paper's greedy Algorithm 1
    #    and the transfer-aware DP that prices the fused executor
    launches = {}
    before = launch_counts()
    table = api.profile_model(
        model, packed, batch_sizes=batch_sizes, repeats=repeats, device=dev
    )
    launches["profile"] = _launched(before)
    ec_greedy = api.map_model(table, policy="greedy")
    ec = api.map_model(table, policy="dp")
    print(f"proper batch size: {ec.proper_batch_size}")
    for label, c, k, b in zip(
        ec.layer_labels, ec.layer_configs,
        ec.per_layer_kernel_times, ec.per_layer_boundary_times,
    ):
        print(f"  {label:12s} -> {c:4s} kernel {k*1e6:7.1f}us "
              f"boundary {b*1e6:7.1f}us")
    _, t_xyz = best_uniform(table, "XYZ")
    t_dp = ec.expected_time_per_example
    t_greedy = ec_greedy.expected_time_per_example
    print(
        f"HEP-dp {t_dp*1e6:.0f} us/img vs "
        f"HEP-greedy {t_greedy*1e6:.0f} us/img vs "
        f"full-XYZ {t_xyz*1e6:.0f} us/img "
        f"(dp is {t_xyz/t_dp:.2f}x vs XYZ, "
        f"{t_greedy/t_dp:.2f}x vs greedy)"
    )

    # 4. build + run the mapped model; verify exactness
    before = launch_counts()
    mapped = build_mapped_model(model, packed, ec, device=dev)
    x, _ = batcher.batch((ds.x, ds.y), 123)
    x = x[: ec.proper_batch_size]
    xw = prepare_input_packed(torch.from_numpy(x))
    out = mapped(xw).numpy()
    launches["mapped"] = _launched(before)
    ref = forward_packed(model.specs, packed, xw).numpy()
    assert np.array_equal(out, ref)
    print("mapped model output == reference (exact)")

    # 5. serve it: the segment-pipelined engine coalesces single
    #    requests into micro-batches of the proper batch size
    engine = ServingEngine(
        model, packed, ec, allowed_batch_sizes=table.batch_sizes, device=dev
    )
    n_req = 8
    xw_all = prepare_input_packed(
        torch.from_numpy(x[:1].repeat(n_req, 0))).numpy()
    before = launch_counts()
    reqs = [engine.submit(xw_all[i]) for i in range(n_req)]
    engine.step(force=True)
    served = [r.wait(1.0) for r in reqs]
    launches["serve"] = _launched(before)
    assert all(np.array_equal(s, ref[0]) for s in served)
    segs = " ".join(
        f"[{s.placement[0].upper()}x{len(s)}]" for s in ec.segments()
    )
    print(f"served {n_req} requests through segment schedule {segs} "
          "— responses exact")
    return {"model": model, "state": state, "metrics": metrics,
            "eval_acc": acc, "packed": packed, "table": table, "ec": ec,
            "ec_greedy": ec_greedy, "t_dp": t_dp, "t_greedy": t_greedy,
            "t_xyz": t_xyz, "xw": xw, "out": out, "ref": ref,
            "served": served, "schedule": segs, "launches": launches}


if __name__ == "__main__":
    main()
