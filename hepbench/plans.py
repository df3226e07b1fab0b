"""Whether a configuration's mapping is stable from one cold plan to the
next, on the card.

    python3 hepbench/plans.py --config cifar10-fused --seed 5

Plans the configuration TIMES times, each in a fresh profile store
under ``build/hepbench_plans/``, as the first run of a cell in a new
checkout does, and prints one JSON line per plan: its seconds (profile,
map, fuse), the mapping and the predicted time per image.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TIMES = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from hepbench import harness
    from hepbench.spec import Bench

    bench = Bench(ROOT)
    config = bench.config(args.config)
    family = bench.family(config)
    dev = torch.device("cuda", 0)
    s_w, s_x, *_ = harness.seeds(args.seed, 4)
    _, weights, images = family.inputs(config, s_w, s_x, dev, 64)
    for k in range(TIMES):
        store = ROOT / "build" / "hepbench_plans" / f"{args.config}-{k}"
        shutil.rmtree(store, ignore_errors=True)
        t = time.monotonic()
        program = family.build_program(config, weights, images, dev,
                                       f"dir://{store}")
        served = program.served
        print(json.dumps({
            "config": args.config, "plan": k, "plan_s": time.monotonic() - t,
            "mapping": harness.mapping_line(served),
            "predicted_us_per_img": served.expected_time_per_example * 1e6,
        }), flush=True)
        del program
    return 0


if __name__ == "__main__":
    sys.exit(main())
