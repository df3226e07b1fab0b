"""The readings that the limits of ``correct`` are set from, on the card.

    python3 hepbench/control.py --workload cifar10-fused.flood \\
        --seconds 3 --seeds 11 12 13

Runs the cell once per seed in one process, as the benchmark runs it,
and prints one JSON line per seed: the program's compared numbers (the
family's checks and ``missing_answers``) and the control's: the family's
reference in the precision below the configuration's (``hepbnn``: every
batch norm evaluated in bfloat16 instead of against its exact
threshold), put in the program's place and held by the family's
agreement rule to the same answered requests.  The benchmark's own runs
never compute the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from hepbench.harness import run_cell
    from hepbench.spec import Bench

    bench = Bench(ROOT)
    for seed in args.seeds:
        t = time.monotonic()
        out = run_cell(bench, args.workload, seed, args.seconds, False,
                       t_start=t, control=True)
        run = out["run"]
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "answered": int((run.done == run.done).sum()),
            **{k: v for k, (v, _) in out["checks"].items()},
            "control_wrong_answers": out["control_wrong_answers"],
            "step_errors": out["step_errors"],
            "run_s": time.monotonic() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
