"""Batched-request serving through the HEP-mapped BNN on PyTorch and CUDA,
via the ``repro_torch.api`` facade (the port of
``examples/serve_mapped.py``): the blessed profile → map → serve path.

``Deployment.plan`` profiles the model (host layers on CPU tensors,
device layers on the card) and maps it with the transfer-aware DP;
``serve()`` stands up the segment-pipelined engine: single-example
requests are coalesced by the dynamic micro-batcher (max-batch = the
mapper's proper batch size, partial batches padded to a profiled batch
size) and executed as a two-stage host/device segment pipeline.
Reports p50/p99 request latency and verifies every response bit-exact
against the reference model.

    PYTHONPATH=src python examples/torch_serve_mapped.py          # on the card
    PYTHONPATH=src python examples/torch_serve_mapped.py \\
        --requests 256 --scale 0.25 --policy greedy --max-wait-ms 5
    PYTHONPATH=src python examples/torch_serve_mapped.py --device cpu
"""

import argparse
from pathlib import Path

import numpy as np
import torch

from repro_torch import api
from repro_torch.bnn import build_model
from repro_torch.bnn.models import (
    forward_packed, pack_params, prepare_input_packed,
)
from repro_torch.data import make_image_dataset
from repro_torch.device import resolve_device
from repro_torch.kernels import launch_counts

SEED = 0


def _launched(before: dict) -> dict:
    """Kernel launches since `before` (a ``launch_counts()``)."""
    return {k: n - before[k] for k, n in launch_counts().items()}


def main(argv=None, *, packed=None) -> dict:
    """Plan, serve and verify; returns ``model``, ``packed``, ``ec``, the
    ``artifact`` path, ``schedule``, the ``scores`` of every request (in
    order), ``ref``, ``latency_us``, ``p50_us`` / ``p99_us``, ``stats``,
    ``accuracy`` and ``launches`` (kernel launches while planning and
    while serving).

    `packed` (keyword only): packed parameters to serve, in place of
    ``pack_params`` of ``model.init`` from a generator seeded 0 (the
    tests carry the JAX package's across)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--policy", default="dp", choices=("greedy", "dp"))
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    model = build_model("fashion_mnist", scale=args.scale)
    if packed is None:
        packed = pack_params(model.specs, model.init(
            torch.Generator(device=dev).manual_seed(SEED), dev), device=dev)

    before = launch_counts()
    dep = api.Deployment.plan(
        (model, packed),
        batch_sizes=(1, 4, 16), policy=args.policy, repeats=2, device=dev,
    )
    launches = {"plan": _launched(before)}
    ec = dep.configuration()
    # own filename: results/efficient_config_fmnist.json is the JAX
    # package's legacy-schema fixture, and serve_mapped_config.json its
    # example's artifact — never clobber either
    artifact = Path("results") / "torch_serve_mapped_config.json"
    artifact.parent.mkdir(exist_ok=True)
    artifact.write_text(ec.to_json())
    print(f"wrote mapping artifact -> {artifact}")
    segs = ec.segments()
    schedule = " ".join(f"[{s.placement[0].upper()}x{len(s)}]" for s in segs)
    print(
        f"schedule: {len(segs)} segments {schedule}"
        f", proper batch {ec.proper_batch_size}"
    )

    dep.serve(max_wait_s=args.max_wait_ms * 1e-3)

    n = args.requests
    ds = make_image_dataset(7, n, model.input_hw, model.in_channels)
    xw_all = prepare_input_packed(torch.from_numpy(ds.x))
    # trickle requests in, stepping as we go: full micro-batches drain
    # immediately, stragglers age out under --max-wait-ms, and a final
    # forced drain flushes the partial tail
    before = launch_counts()
    reqs = []
    served = 0
    xw_np = xw_all.numpy()
    for i in range(n):
        reqs.append(dep.submit(xw_np[i]))
        served += dep.step()
    served += dep.drain()
    launches["serve"] = _launched(before)
    assert served == n

    ref = forward_packed(model.specs, packed, xw_all).numpy()
    correct = 0
    lat_us, scores = [], []
    for i, r in enumerate(reqs):
        s = r.wait(timeout=1.0)
        assert np.array_equal(s, ref[i]), f"response {i} mismatch"
        scores.append(s)
        lat_us.append(r.latency_s * 1e6)
        correct += int(np.argmax(s) == ds.y[i])
    lat_us = np.asarray(lat_us)
    p50, p99 = np.percentile(lat_us, 50), np.percentile(lat_us, 99)
    stats = dep.stats()
    print(
        f"served {stats['served']} requests @ max_batch "
        f"{ec.proper_batch_size}: "
        f"p50 {p50:.0f}us  "
        f"p99 {p99:.0f}us  "
        f"(untrained acc {correct / n:.3f})"
    )
    print("all responses verified exact vs reference")
    return {"model": model, "packed": packed, "ec": ec,
            "artifact": artifact, "schedule": schedule,
            "scores": np.stack(scores), "ref": ref, "latency_us": lat_us,
            "p50_us": float(p50), "p99_us": float(p99), "stats": stats,
            "accuracy": correct / n, "launches": launches}


if __name__ == "__main__":
    main()
