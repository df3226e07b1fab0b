"""HEP-Shard demo on PyTorch (the port of ``examples/hep_shard_demo.py``):
the paper's greedy mapping algorithm selecting a sharding scheme for an
LM cell from dry-run costs, on an 8-rank debug mesh (2 data x 4 model).

    PYTHONPATH=src python examples/torch_hep_shard_demo.py --arch olmo_1b
    PYTHONPATH=src python examples/torch_hep_shard_demo.py --device cpu

Each trial is ``launch.dryrun.dry_run`` of one train step on a (2, 4)
``DeviceMesh`` over ``launch.mesh.fake_process_group(8)``: the port has
no compiled HLO, so the per-device matmul FLOPs, HBM bytes, collective
bytes and peak come from an eager trace of the step on fake DTensors
(nothing is allocated, no collective moves data), priced at the H100's
datasheet rates.  The mesh is a CUDA one by default (the card's path;
it needs a card) and a CPU one under ``--device cpu``.
"""

import argparse
import dataclasses

from repro_torch import configs as C
from repro_torch.core.cost_model import LAUNCH_S, PCIE_BW
from repro_torch.core.hep_shard import ShardTrial, device_hbm_bytes, search
from repro_torch.device import resolve_device
from repro_torch.launch.dryrun import HBM_BW, LINK_BW, PEAK_BF16, dry_run
from repro_torch.launch.mesh import fake_process_group, make_debug_mesh

MESH = (2, 4)
AXES = ("data", "model")
KNOBS = {  # reduced lattice for the demo
    "tp": (True, False),
    "fsdp": ("zero1", "zero3"),
    "batch_over_model": (False, True),
}
# the device memory the peaks are held to without a card to read it
# from: the H100 80GB's (data sheet)
H100_HBM_BYTES = 80 * 10**9


def main(argv=None, *, cfg=None, shape=None) -> dict:
    """Search the knob lattice; returns ``cfg``, ``shape``, ``best`` (the
    chosen ``ShardTrial``), ``history`` (the search's, in order) and
    ``trials`` ({scheme: its ``ShardTrial``}, every scheme evaluated).

    `cfg` and `shape` (keyword only): a ``ModelConfig`` and a
    ``configs.ShapeCell`` in place of ``--arch`` / ``--layers`` and
    ``--shape`` (the tests trace a smoke config at a small shape)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if cfg is None:
        cfg = dataclasses.replace(C.get(args.arch), n_layers=args.layers)
    sh = C.SHAPES[args.shape] if shape is None else shape
    # real per-step host staging: the token batch up (ids + targets,
    # int32) and the metrics scalars down — parameters and optimizer
    # state stay device-resident across steps and are NOT charged.
    # The global batch reaches the devices whole under every scheme, so
    # this term is scheme-invariant: reporting-only, it never moves the
    # search's argmin (scheme-dependent staging would mis-price
    # resident state, the bias the layer-level DP exists to avoid).
    # Priced over the card's PCIe link, each copy paying a launch.
    step_in_bytes = 2 * sh.batch * sh.seq * 4
    hbm = device_hbm_bytes(dev) if dev.type == "cuda" else H100_HBM_BYTES
    trials = {}

    def evaluate(scheme):
        res = dry_run(cfg, sh, mesh, scheme, device=dev)
        per_device = res["per_device"]
        trials[scheme] = ShardTrial(
            scheme=scheme,
            compute_s=per_device["hlo_flops"] / PEAK_BF16,
            memory_s=per_device["hlo_bytes"] / HBM_BW,
            collective_s=res["collectives"]["per_device_bytes"] / LINK_BW,
            peak_bytes=res["memory"]["peak_bytes_per_device"],
            # host staging split the same way the layer profiler splits
            # kernel vs boundary
            h2d_s=LAUNCH_S + step_in_bytes / PCIE_BW,
            d2h_s=LAUNCH_S,
            hbm_bytes=hbm,
        )
        return trials[scheme]

    with fake_process_group(MESH[0] * MESH[1]):
        mesh = make_debug_mesh(MESH, AXES, device_type=dev.type)
        best, history = search(evaluate, knobs=KNOBS, max_rounds=2)
    print(f"\nevaluated {len(history)} trials; best scheme:")
    print(f"  {best.scheme}")
    print(
        f"  compute {best.compute_s*1e3:.2f}ms  "
        f"memory {best.memory_s*1e3:.2f}ms  "
        f"collective {best.collective_s*1e3:.2f}ms  "
        f"transfer {best.transfer_s*1e3:.2f}ms  "
        f"peak {best.peak_bytes/2**30:.2f}GiB"
    )
    return {"cfg": cfg, "shape": sh, "best": best, "history": history,
            "trials": trials}


if __name__ == "__main__":
    main()
