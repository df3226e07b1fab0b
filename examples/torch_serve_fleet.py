"""Co-serve two BNN models on one CPU + GPU machine through the
``repro_torch.api`` facade (the port of ``examples/serve_fleet.py``):
contention-aware joint mapping, SLO router, device-time ledger — one
``Deployment`` object end to end.

1. ``Deployment.plan`` profiles both models over the near-tied
   CPU/XYZ placement pair (host layers on CPU tensors, ``XYZ`` layers
   by the packed xnor/popcount kernel on the card) and jointly maps them
   under the contention-inflation model (never worse than
   both-solo-all-GPU), persisting the joint mappings in a
   **fleet-scoped** ``ProfileStore`` key (a mapping optimized against
   these co-runners must not warm-start a solo deployment, or another
   fleet);
2. ``serve(adapt=True)`` stands up the ``FleetRouter``: per-tenant
   priorities and deadlines, admission control shedding requests that
   would miss their SLO, a shared ``DeviceTimeLedger`` metering who
   occupied what, and one tenant-named ``RemapController`` per engine
   (namespaced journals) sharing the fleet store.

Every served response is verified bit-exact against its model's packed
reference.

    PYTHONPATH=src python examples/torch_serve_fleet.py            # on the card
    PYTHONPATH=src python examples/torch_serve_fleet.py --smoke
    PYTHONPATH=src python examples/torch_serve_fleet.py --smoke --device cpu
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch import api
from repro_torch.bnn import build_model
from repro_torch.bnn.models import (
    forward_packed, pack_params, prepare_input_packed,
)
from repro_torch.core.parallel_config import CPU, FULL_GPU
from repro_torch.device import resolve_device
from repro_torch.kernels import launch_counts
from repro_torch.store import ProfileStore, fleet_scope

SPACE = (CPU, FULL_GPU)
SEED = 0
INPUT_SEED = 7


def _launched(before: dict) -> dict:
    """Kernel launches since `before` (a ``launch_counts()``)."""
    return {k: n - before[k] for k, n in launch_counts().items()}


def main(argv=None, *, packed=None) -> dict:
    """Plan, serve and verify; returns ``names``, ``models`` ({name:
    (model, packed)}), ``store``, ``plan`` (the ``FleetPlan``),
    ``schedules``, ``inputs`` / ``refs`` / ``answers`` ({name: packed
    inputs, reference scores, [(index, scores)] of the served
    requests}), ``shed``, ``p50_us`` / ``p99_us``, ``stats`` and
    ``launches`` (kernel launches while planning and while serving).

    `packed` (keyword only): {name: packed parameters} to serve, in place
    of ``pack_params`` of each model's ``init`` from a generator seeded
    0 (the tests carry the JAX package's across)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument("--requests", type=int, default=128,
                    help="per tenant")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes for the CI docs job")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.smoke:
        args.scale, args.requests = 0.25, 32

    names = ("narrow", "wide")
    models = {}
    for name, s in zip(names, (args.scale, args.scale * 1.5)):
        m = build_model("fashion_mnist", scale=s)
        if packed is not None:
            p = packed[name]
        else:
            p = pack_params(m.specs, m.init(
                torch.Generator(device=dev).manual_seed(SEED), dev),
                device=dev)
        models[name] = (m, p)

    # fleet-scoped persistence: these mappings key under this exact
    # co-tenancy — a solo warm start can never pick them up
    store = ProfileStore(
        tempfile.mkdtemp(prefix="fleet_store_"),
        scope=fleet_scope(names), device=dev,
    )
    before = launch_counts()
    dep = api.Deployment.plan(
        models, store=store, configs=SPACE,
        batch_sizes=(args.batch,), gamma=2.0, repeats=1,
        priorities={"narrow": 1}, device=dev,
    )
    launches = {"plan": _launched(before)}
    plan = dep.fleet_plan
    print(
        f"joint plan: makespan {plan.joint_makespan_s * 1e6:.0f}us "
        f"vs all-GPU {plan.baseline_makespan_s * 1e6:.0f}us "
        f"({plan.vs_all_gpu:.2f}x, {plan.rounds} descent rounds)"
    )
    schedules = {}
    for t in plan.tenants:
        segs = t.config.segments()
        schedules[t.name] = " ".join(
            f"[{s.placement[0].upper()}x{len(s)}]" for s in segs)
        print(
            f"  {t.name}: {schedules[t.name]}"
            f" infl(host={t.host_inflation:.2f}, "
            f"dev={t.device_inflation:.2f})"
        )
    print(f"persisted joint mappings under scope {store.scope}")

    # the narrow tenant is latency-critical: higher priority (set at
    # plan time), a deadline tight enough that backlog bursts get shed
    narrow = dep.tenants["narrow"].config
    narrow_step_s = (
        narrow.expected_time_per_example * narrow.proper_batch_size
    )
    dep.tenants["narrow"].deadline_s = 4.0 * narrow_step_s

    dep.serve(adapt=True, telemetry_sample_every=2)

    n = args.requests
    xs, refs, reqs = {}, {}, {name: [] for name in names}
    for name in names:
        m, p = models[name]
        x01 = torch.rand((n, *m.input_hw, m.in_channels),
                         generator=torch.Generator().manual_seed(INPUT_SEED))
        xw = prepare_input_packed(x01)
        xs[name] = xw.numpy()
        refs[name] = forward_packed(m.specs, p, xw).numpy()

    # interleaved trickle: the narrow tenant bursts 2 requests per
    # round, the wide one 1; the router steps as traffic arrives
    before = launch_counts()
    i = {name: 0 for name in names}
    while any(i[name] < n for name in names):
        for name, per_round in (("narrow", 2), ("wide", 1)):
            for _ in range(per_round):
                if i[name] < n:
                    reqs[name].append(
                        (i[name], dep.submit(xs[name][i[name]],
                                             tenant=name))
                    )
                    i[name] += 1
        dep.step()
    dep.drain()
    launches["serve"] = _launched(before)

    stats = dep.stats()
    answers, shed_by, p50s, p99s = {}, {}, {}, {}
    for name in names:
        lat_us, shed, got = [], 0, []
        for j, r in reqs[name]:
            if r is None:
                shed += 1
                continue
            scores = r.wait(timeout=5.0)
            assert np.array_equal(scores, refs[name][j]), (
                f"{name} response {j} mismatch"
            )
            got.append((j, scores))
            lat_us.append(r.latency_s * 1e6)
        s = stats["tenants"][name]
        u = stats["ledger"][name]
        answers[name], shed_by[name] = got, shed
        p50s[name] = float(np.percentile(lat_us, 50))
        p99s[name] = float(np.percentile(lat_us, 99))
        print(
            f"{name}: served {s['served']} shed {shed} "
            f"p50 {p50s[name]:.0f}us "
            f"p99 {p99s[name]:.0f}us  "
            f"ledger host {u['host_s'] * 1e3:.1f}ms / "
            f"device {u['device_s'] * 1e3:.1f}ms"
        )
        assert s["rejected"] == shed
    print("all served responses verified exact vs per-model references")
    return {"names": names, "models": models, "store": store,
            "plan": plan, "schedules": schedules, "inputs": xs,
            "refs": refs, "answers": answers, "shed": shed_by,
            "p50_us": p50s, "p99_us": p99s, "stats": stats,
            "launches": launches}


if __name__ == "__main__":
    main()
