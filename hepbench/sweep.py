"""The rate sweep that sets each ``open`` cell's rate, on the card.

    python3 hepbench/sweep.py --config cifar10-fused --seed 5

Sets the configuration up once, measures its ``flood`` throughput, then
offers Poisson traffic at fractions of it (FRACTIONS: 0.4 to 1.2), one
window of WINDOW_S each, and prints one JSON line per rate: offered and
served rates, p95 latency, the share of requests due in the window that were
answered in it, and the mean queue depth (requests due and not yet
answered) over the middle tenth and the last tenth of the window.  The
knee is the highest rate that, with every lower rate of the sweep, keeps
no growing backlog: at least 99 % answered in the window, and the last
tenth's depth no more than one proper batch above the middle tenth's (a
rate past the first failure that happens to pass is noise, not
capacity).  A cell takes 0.8 x the knee.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

FRACTIONS = (0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2)
WINDOW_S = 5.0


def depth(due, done, t) -> float:
    """Requests due by `t` and not answered by `t`."""
    import numpy as np

    return float(np.sum(due <= t) - np.sum(done <= t))


def window_stats(t0, t_end, r, seconds: float) -> dict:
    import numpy as np

    due, done = r["due"], np.nan_to_num(r["done"], nan=np.inf)
    in_win = due < t_end
    lat = (done[in_win] - due[in_win]) * 1e3

    def mean_depth(a, b):
        ts = t0 + seconds * np.linspace(a, b, 50)
        return float(np.mean([depth(due, done, t) for t in ts]))

    return {"served_img_s": float(np.sum(done < t_end) / seconds),
            "p95_ms": float(np.percentile(lat, 95)),
            "answered_share": float(np.mean(done[in_win] < t_end)),
            "depth_mid": mean_depth(0.45, 0.55),
            "depth_end": mean_depth(0.9, 1.0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from hepbench import harness, traffic
    from hepbench.spec import Bench

    bench = Bench(ROOT)
    config = bench.config(args.config)
    family = bench.family(config)
    dev = torch.device("cuda", 0)
    s_w, s_x, s_t, s_warm = harness.seeds(args.seed, 4)
    _, weights, images = family.inputs(config, s_w, s_x, dev, harness.POOL)
    program = family.build_program(config, weights, images, dev,
                                   harness.store_uri(ROOT, args.config))
    harness.log(harness.mapping_line(program.served))
    flood = {"kind": "closed", "outstanding": 128}
    harness.warm(program, flood, s_warm)
    t0, t_end, rec, _, _ = harness.drive(
        program, traffic.schedule(flood, s_t, WINDOW_S, harness.POOL),
        WINDOW_S)
    base = window_stats(t0, t_end, rec, WINDOW_S)["served_img_s"]
    print(json.dumps({"config": args.config, "flood_img_s": base}),
          flush=True)
    batch = program.served.proper_batch_size
    knee, failed = None, False
    for f in FRACTIONS:
        rate = round(f * base)
        mix = {"kind": "poisson", "rate_per_s": rate}
        t = time.monotonic()
        t0, t_end, rec, _, _ = harness.drive(
            program, traffic.schedule(mix, s_t, WINDOW_S, harness.POOL),
            WINDOW_S)
        row = {"config": args.config, "fraction": f, "offered_img_s": rate,
               **window_stats(t0, t_end, rec, WINDOW_S),
               "wall_s": time.monotonic() - t}
        row["sustained"] = (row["answered_share"] >= 0.99 and
                            row["depth_end"] <= row["depth_mid"] + batch)
        if not row["sustained"]:
            failed = True
        elif not failed:
            knee = rate
        print(json.dumps(row), flush=True)
    print(json.dumps({"config": args.config, "knee_img_s": knee,
                      "cell_rate_per_s": None if knee is None
                      else round(0.8 * knee)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
