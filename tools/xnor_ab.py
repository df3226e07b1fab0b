#!/usr/bin/env python3
"""A/B of kernel 1, ``xnor_gemm_cuda``, between two source trees on one card.

    python3 tools/xnor_ab.py --parent DIR [--json PATH]

DIR holds another checkout of the repository, for example the parent
commit unpacked with ``git archive <commit> | tar -x -C DIR`` into a
git-ignored directory.  The script runs the same sweep in four child
processes, in the order parent, this tree, this tree, parent.  Each
child imports ``repro_torch`` from its tree's ``src/``, builds that
tree's kernels and times ``xnor_gemm_cuda`` under all 7 aspect
configurations at every CIFAR-10 GEMM layer (random words of the
layer's full-width shape; B 16 and B 1): the device time per launch
from a profiler trace of each case, and the time per call from CUDA
events over back-to-back calls (the wrapper's host path included).  It
prints, per case, each tree's mean of its two runs and the ratio, and
writes all four runs to PATH as JSON.  Run it on a machine with an
NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

BATCHES = (16, 1)
ITERS = 20


def child(src: Path, out: Path) -> None:
    """One side: sweep the tree at `src` and write {case: [device ms, call
    ms]} and the card's name to `out`."""
    sys.path.insert(0, str(src / "src"))
    import torch
    from repro_torch.kernels import xnor_gemm_cuda

    if not torch.cuda.is_available():
        raise SystemExit("xnor_ab: no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(0)
    cases = []
    for b in BATCHES:
        for name, p, n, kw, k_true in chip_smoke.GEMM_SHAPES:
            a = torch.randint(-2**31, 2**31 - 1, (b, p, kw), generator=gen,
                              dtype=torch.int32).to(dev)
            w = torch.randint(-2**31, 2**31 - 1, (n, kw), generator=gen,
                              dtype=torch.int32).to(dev)
            for asp in chip_smoke.ASPECT_SETS:
                cases.append((f"{name} B{b} {asp}",
                              lambda a=a, w=w, k=k_true, asp=asp:
                              xnor_gemm_cuda(a, w, k, tuple(asp))))
    dev_ms, _ = chip_smoke.kernel_sweep(cases, "xnor_gemm_kernel", ITERS)
    call_ms = {label: chip_smoke.time_ms(fn, ITERS) for label, fn in cases}
    out.write_text(json.dumps({
        "src": str(src), "device": chip_smoke.smi("name,power.limit"),
        "cases": {k: [dev_ms[k], call_ms[k]] for k in dev_ms}}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="the other checkout")
    ap.add_argument("--json", type=Path,
                    default=ROOT / "build" / "xnor_ab.json")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child.resolve(), args.out)
        return 0
    if args.parent is None:
        ap.error("--parent DIR is required")
    args.json.parent.mkdir(parents=True, exist_ok=True)
    runs = []
    for side, src in (("parent", args.parent), ("change", ROOT),
                      ("change", ROOT), ("parent", args.parent)):
        out = args.json.with_suffix(f".{len(runs)}.json")
        subprocess.run([sys.executable, __file__, "--child",
                        str(src.resolve()), "--out", str(out)], check=True,
                       timeout=900)
        runs.append((side, json.loads(out.read_text())))
        out.unlink()
    args.json.write_text(json.dumps(
        [{"side": side, **run} for side, run in runs], indent=1))
    print(runs[0][1]["device"])
    mean = {}
    for side in ("parent", "change"):
        got = [r["cases"] for s, r in runs if s == side]
        mean[side] = {k: [(got[0][k][i] + got[1][k][i]) / 2 for i in (0, 1)]
                      for k in got[0]}
    print("case: device ms per launch parent -> change (ratio); per call "
          "parent -> change (ratio)")
    for k, (pd, pc) in mean["parent"].items():
        cd, cc = mean["change"][k]
        print(f"{k}: {pd:.5f} -> {cd:.5f} ({pd / cd:.2f}x); "
              f"{pc:.5f} -> {cc:.5f} ({pc / cc:.2f}x)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
