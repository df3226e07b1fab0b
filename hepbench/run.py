"""The benchmark of ``repro_torch``: one run of one cell.

    python3 hepbench/run.py --workload cifar10-fused.flood --seed 7 \\
        --seconds 10 --trace 0

Loads the cell, its configuration and its traffic mix by name from
``BENCHMARK.json``, and the configuration's family file
(``hepbench/families/<family>.py``, ``hepbnn`` where the configuration
names none; ``spec.py`` says what a family file holds).  Through the
family it makes the net, weights and images from ``--seed`` on the card
and sets the port up through ``repro_torch.api.Deployment`` (a profile
store and the kernel builds live under ``build/`` of this checkout);
then it warms up with the cell's own traffic, measures for
``--seconds``, holds every answer to the family's plain reference by the
family's agreement rule, and prints one JSON line last on standard
output: the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics and a device trace of the family's kernels (``--trace 1``).  The
numbers compared, each beside its limit, are the last lines on standard
error and the line's last key.  Exits non-zero, printing no result,
without a CUDA card, or when JAX or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _paths(root: Path) -> None:
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = root / "build" / "hepbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def forbidden_modules(names=None) -> list:
    """The loaded modules (`names`, default ``sys.modules``) whose top-level
    name is JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def result(bench, out: dict, trace: bool, device) -> dict:
    import numpy as np
    import torch

    run = out["run"]
    cell = run.cell["name"]
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(cell, kind):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": False, "attempted": 0, "failed": 0,
            "metrics": metrics, "device": dev}
    if trace and run.slices:
        from hepbench.readings import complete_slice

        sl = complete_slice(run) or max(
            run.slices, key=lambda s: sum(s.traced.values()))
        dev.update(busy_s=sl.busy_s, window_s=sl.window_s)
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in sl.device_ops],
            "idle_gaps": [[n, s] for n, s in sl.idle_gaps]}
    from hepbench.harness import served_segments

    line["mapping"] = served_segments(run.served)
    checks = out["checks"]
    in_window = run.in_window
    line["attempted"] = int(in_window.sum())
    line["failed"] = int(np.isnan(run.done[in_window]).sum())
    line["correct"] = (all(v <= lim for v, lim in checks.values())
                      and out["step_errors"] == 0)
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def main(argv=None, *, root: Path = ROOT, device: str = "cuda",
         t_start: float | None = None) -> int:
    """`device` other than ``cuda`` (the tests' CPU runs) skips the look
    for a card; `t_start` is when set-up began (the process's start)."""
    args = _args(argv)
    _paths(root)
    import torch

    from hepbench.harness import log, run_cell
    from hepbench.spec import Bench

    bench = Bench(root)
    cell = bench.cell(args.workload)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
            f"{torch.cuda.device_count()} available")
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), device=device, t_start=t_start)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    line = result(bench, out, bool(args.trace), dev)
    loaded = forbidden_modules()
    if loaded:
        log(f"JAX or the JAX package is loaded: {loaded}")
        return 3
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
