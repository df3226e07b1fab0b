"""The scheme hillclimb — the counterpart of ``repro.launch.hillclimb``:
dry-run named ShardScheme variants of the chosen LM cells, derive the
roofline terms, and log hypothesis -> change -> before -> after.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell qwen-prefill
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell deepseek --device cpu

Each variant is one ``launch.dryrun`` trace of the cell's step on the
16 x 16 fake mesh (the reference compiles it through XLA); its terms are
priced with the H100's datasheet constants (``dryrun.PEAK_BF16``,
``HBM_BW``, ``LINK_BW``), so they are derived numbers, not measured
ones.  ``CELLS`` is the reference's, hypotheses word for word: they
were written about the v5e's compiled programs.

Also hosts the BNN *mapping* hillclimb (``--bnn`` /
:func:`bnn_mapping_hillclimb`): local search over per-layer
implementations whose move space is each profile row's own candidate
set — the kernel-variant registry's variable-size per-layer spaces the
DP mapper searches — not the hard-coded fixed 8.  It is pure logic over
a :class:`~repro_torch.core.profiler.ProfileTable`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from repro_torch import configs as C
from repro_torch.core.mapper import attribute_fused_costs, price_mapping
from repro_torch.launch import dryrun
from repro_torch.parallel.sharding import default_scheme


def _fused_total(table, batch, mapping) -> float:
    kernels, boundaries = attribute_fused_costs(table, batch, mapping)
    return sum(kernels) + sum(boundaries)


def bnn_mapping_hillclimb(
    table, *, batch=None, start=None, max_sweeps: int = 50
):
    """First-improvement hillclimb over per-layer configs under the
    fused cost model (the DP's objective).

    The move space for layer *i* at batch *b* is
    ``table.configs_for(b, i)`` — the row's own registry-driven
    candidate set, so tables with registered variants are climbed over
    their full variable-size spaces; nothing assumes the paper's fixed
    8.

    ``start=None`` seeds each batch's climb from the paper's greedy
    per-layer argmin.  Sweeps layers repeatedly until a full sweep
    finds no improving move (or ``max_sweeps``), then returns
    ``(EfficientConfiguration, trajectory)`` for the best batch size,
    where ``trajectory`` is the accepted-total series (before -> after
    per accepted move).  The DP is exact for this objective, so the
    result is sandwiched: DP total <= hillclimb total <= start total.
    """
    batches = table.batch_sizes if batch is None else (batch,)
    best = None                      # (total, batch, mapping, trajectory)
    n_layers = len(table.layer_labels)
    for b in batches:
        if start is None:
            mapping = [
                min(
                    table.configs_for(b, i),
                    key=lambda c: table.times[b][i][c],
                )
                for i in range(n_layers)
            ]
        else:
            mapping = list(start)
        total = _fused_total(table, b, mapping)
        trajectory = [total]
        for _ in range(max_sweeps):
            improved = False
            for i in range(n_layers):
                for cand in table.configs_for(b, i):
                    if cand == mapping[i]:
                        continue
                    prev = mapping[i]
                    mapping[i] = cand
                    t = _fused_total(table, b, mapping)
                    if t < total:
                        total = t
                        trajectory.append(t)
                        improved = True
                    else:
                        mapping[i] = prev
            if not improved:
                break
        if best is None or total < best[0]:
            best = (total, b, tuple(mapping), trajectory)
    total, b, mapping, trajectory = best
    return price_mapping(table, b, mapping), trajectory


# The three hillclimb cells (see EXPERIMENTS.md §Perf for selection
# rationale) and their variant ladders. Each variant records the
# hypothesis it tests.
CELLS = {
    "qwen": {
        "arch": "qwen2_5_14b", "shape": "train_4k",
        "why": "worst collective/compute ratio (16x): 40 heads % 16 != 0",
        "variants": [
            ("baseline", {},
             "paper-faithful default: TP+ZeRO-1"),
            ("attn-dp", {"attn_tp": False},
             "H1: chunk-loop all-reduces come from uneven head sharding;"
             " replicating attention weights removes them"),
            ("attn-dp+accum4", {"attn_tp": False, "accum_steps": 4},
             "H2: peak memory is saved-residual dominated; 4 microbatches"
             " cut live activations ~4x at unchanged math"),
            ("accum4", {"accum_steps": 4},
             "H2 control: accum without the attention fix"),
            ("sp", {"sp_residual": True},
             "H3: sequence-parallel residuals shard the saved (B,S,d)"
             " carries 16x over 'model' — memory term down without the"
             " attn-dp compute blowup"),
            ("sp+accum2", {"sp_residual": True, "accum_steps": 2},
             "H4: SP + 2 microbatches fits HBM"),
            ("kvpar", {"attn_kv_parallel": True},
             "H5: keep head-TP projections but compute the attention"
             " inner with KV parts sharded over 'model' + logsumexp"
             " combine — only (B,H,qc,hd) all-reduces remain"),
            ("kvpar+accum4",
             {"attn_kv_parallel": True, "accum_steps": 4},
             "H6: H5 + microbatching = fits HBM at the lower"
             " collective point"),
            ("kvpar+accum8",
             {"attn_kv_parallel": True, "accum_steps": 8},
             "H7: 8 microbatches -> peak under the 16 GiB HBM line"),
        ],
    },
    "grok": {
        "arch": "grok_1_314b", "shape": "train_4k",
        "why": "most collective-bound cell overall; 314B MoE, ZeRO-3",
        "variants": [
            ("baseline", {},
             "paper-faithful default: TP+ZeRO-3, expert TP (8 experts"
             " % 16 != 0)"),
            ("accum8", {"accum_steps": 8},
             "H1: 162 GiB/dev peak is layer-residual dominated"
             " (64L x 16 local seqs); 8 microbatches -> ~1/8 residents"),
            ("accum8+attn-dp", {"accum_steps": 8, "attn_tp": False},
             "H2: 48H%16==0 so head sharding is clean — expect attn-dp"
             " to NOT help (control for H1 of the qwen cell)"),
            ("zero1+accum8", {"fsdp": "zero1", "accum_steps": 8},
             "H3: ZeRO-3 weight re-gathers per microbatch dominate"
             " collectives; ZeRO-1 trades +param memory for -gathers"
             " (expect OOM: params/16 = 39 GiB/dev — measure anyway)"),
            ("accum2", {"accum_steps": 2},
             "H4: regather cost scales with accum count — 2 microbatches"
             " should halve the memory win of accum8 but keep most of"
             " the collective budget"),
            ("sp+accum2", {"sp_residual": True, "accum_steps": 2},
             "H5: grok's 48H%16==0 heads shard cleanly, so SP residuals"
             " may not trigger qwen's resharding storm — residual memory"
             " /16 without accum's regather multiplication"),
            ("e-zero3", {"moe_e_over_data": True},
             "H6 (from HLO attribution): 720 GiB/layer-pass comes from"
             " wd's d@data making the BACKWARD contraction partial-sum;"
             " ZeRO-3 on the expert dim (8 over 16, padded) removes"
             " contraction sharding in both directions at 2x wd storage"),
            ("e-zero3+accum2", {"moe_e_over_data": True,
                                "accum_steps": 2},
             "H7: H6 + microbatching for the memory Pareto"),
        ],
    },
    "qwen-prefill": {
        "arch": "qwen2_5_14b", "shape": "prefill_32k",
        "why": "bonus 5th cell: most collective-bound cell in the whole"
               " table (2.2 TiB/dev) — the 40H/16 pathology at 32k ctx",
        "variants": [
            ("baseline", {},
             "paper-faithful default"),
            ("kvpar", {"attn_kv_parallel": True},
             "H1: same mechanism as the train cell — KV-part-sharded"
             " inner with logsumexp combine removes the per-chunk"
             " partial-sum all-reduces at 32k context too"),
        ],
    },
    "grok-decode": {
        "arch": "grok_1_314b", "shape": "decode_32k",
        "why": "bonus 4th cell: worst useful_ratio in the table (0.01) —"
               " ZeRO-3 weights are re-gathered for every decoded token",
        "variants": [
            ("baseline", {},
             "paper-faithful default: same scheme as training"),
            ("wstat", {"decode_replicate_batch": True},
             "H1: weight-stationary 2D-TP decode — replicate the ~MB"
             " per-token activations, never move the 632 GB of weights;"
             " predicted collective drop ~100x (weights dominate)"),
            ("wstat+ep", {"decode_replicate_batch": True,
                          "expert_mode": "ep"},
             "H2: with activations replicated, 8-expert EP (uneven over"
             " 16) may beat expert-TP for decode (each token hits only"
             " 2 experts)"),
            ("contr2d", {"out_proj_contracting_2d": True},
             "H3 (from HLO attribution): 440 GiB/step is wd all-gathered"
             " over 'data' per token; shard wd's CONTRACTING dim 2D ->"
             " partial-sum all-reduce of ~50 MB outputs instead;"
             " predicted coll 10.4s -> ~1.5s"),
        ],
    },
    "deepseek": {
        "arch": "deepseek_moe_16b", "shape": "train_4k",
        "why": "most representative of the paper's technique: the EP-vs-TP"
               " expert placement IS a layer-to-device mapping choice",
        "variants": [
            ("baseline", {},
             "paper-faithful default: expert-parallel (64e % 16 == 0)"),
            ("expert-tp", {"expert_mode": "tp"},
             "H1: EP all-to-alls vs TP all-reduces — fine-grained 1408-"
             "wide experts are too small for 16-way TP (88 cols/shard);"
             " expect EP to win (confirming 'auto')"),
            ("ep+accum4", {"accum_steps": 4},
             "H2: 34 GiB/dev peak -> fits HBM with microbatching"),
            ("ep+attn-dp+accum4", {"attn_tp": False, "accum_steps": 4},
             "H3: 16H/16 model axis = 1 head per chip — replicating"
             " attention may still cut resharding around GQA"),
        ],
    },
}


def evaluate(arch: str, shape: str, overrides: dict, *,
             device="cuda") -> dict:
    """One variant: the cell's step dry-run on the 16 x 16 fake mesh
    under ``default_scheme`` with `overrides`, as the reference's
    roofline terms (seconds, GiB per device)."""
    cfg = C.get(arch)
    scheme = dataclasses.replace(default_scheme(cfg), **overrides)
    r = dryrun.run_cell(arch, shape, multi_pod=False, scheme=scheme,
                        device=device)
    flops = r["per_device"]["hlo_flops"]
    bytes_ = r["per_device"]["hlo_bytes"]
    coll = r["collectives"]
    return {
        "compute_s": flops / dryrun.PEAK_BF16,
        "memory_s": bytes_ / dryrun.HBM_BW,
        "collective_s": coll["per_device_bytes"] / dryrun.LINK_BW,
        "peak_gib": r["memory"]["peak_bytes_per_device"] / 2**30,
        "coll_gib": coll["per_device_bytes"] / 2**30,
        "coll_by_kind_gib": {
            k: v / 2**30 for k, v in coll["by_kind_bytes"].items()
        },
    }


def run_cell(key: str, outdir: Path, *, device="cuda") -> list:
    """Every variant of ``CELLS[key]``, each written to
    ``outdir/<key>__<variant>.json`` (read back instead when it is
    there), one table line each."""
    spec = CELLS[key]
    print(f"\n=== {key}: {spec['arch']} / {spec['shape']} ===")
    print(f"    ({spec['why']})")
    results = []
    for name, overrides, hyp in spec["variants"]:
        fp = outdir / f"{key}__{name}.json"
        if fp.exists():
            r = json.loads(fp.read_text())
        else:
            try:
                r = evaluate(spec["arch"], spec["shape"], overrides,
                             device=device)
                r["variant"] = name
                r["hypothesis"] = hyp
                r["overrides"] = overrides
            except Exception as e:
                r = {"variant": name, "error": repr(e), "hypothesis": hyp}
            fp.write_text(json.dumps(r, indent=2, default=float))
        results.append(r)
        if "error" in r:
            print(f"  {name:22s} ERROR {r['error'][:60]}")
            continue
        step = max(r["compute_s"], r["memory_s"]) + r["collective_s"]
        print(
            f"  {name:22s} step~{step:7.2f}s  "
            f"cmp {r['compute_s']:6.2f}  mem {r['memory_s']:6.2f}  "
            f"coll {r['collective_s']:6.2f}  peak {r['peak_gib']:6.1f}GiB"
        )
    return results


def run_bnn(outdir: Path, *, device=None) -> dict:
    """Hillclimb a BNN mapping on an autotuned (registry-space) profile
    with the analytic time source, and log it against the exact DP on
    the same table; writes ``outdir/bnn_mapping_hillclimb.json`` and
    returns what it wrote.  `device` holds the packed weights (``None``
    -> ``cuda``)."""
    import torch

    from repro_torch.bnn import build_model
    from repro_torch.bnn.models import pack_params
    from repro_torch.core.mapper import map_efficient_configuration
    from repro_torch.core.profiler import autotune_bnn_model

    m = build_model("fashion_mnist", scale=0.25)
    gen = torch.Generator().manual_seed(0)
    packed = pack_params(m.specs, m.init(gen, device="cpu"), device=device)
    table = autotune_bnn_model(
        m, packed, batch_sizes=(1, 4, 16), time_source="analytic",
        device=device,
    )
    ec_hc, trajectory = bnn_mapping_hillclimb(table)
    ec_dp = map_efficient_configuration(table, policy="dp")
    space = sum(
        len(table.configs_for(ec_hc.proper_batch_size, i))
        for i in range(len(table.layer_labels))
    )
    print(f"\n=== bnn-mapping hillclimb: {m.name} (autotuned space) ===")
    print(f"  space: {space} summed per-layer candidates "
          f"(registry-driven, variable-size)")
    print(f"  start  {trajectory[0] * 1e6:9.2f} us/ex "
          f"(greedy argmin seed)")
    print(f"  climb  {ec_hc.expected_time_per_example * 1e6:9.2f} us/ex "
          f"@b{ec_hc.proper_batch_size} "
          f"({len(trajectory) - 1} accepted moves)")
    print(f"  dp     {ec_dp.expected_time_per_example * 1e6:9.2f} us/ex "
          f"@b{ec_dp.proper_batch_size} (exact)")
    out = {
        "model": m.name,
        "space": space,
        "trajectory_us": [t * 1e6 for t in trajectory],
        "hillclimb_us": ec_hc.expected_time_per_example * 1e6,
        "hillclimb_mapping": list(ec_hc.layer_configs),
        "dp_us": ec_dp.expected_time_per_example * 1e6,
        "dp_mapping": list(ec_dp.layer_configs),
    }
    fp = outdir / "bnn_mapping_hillclimb.json"
    fp.write_text(json.dumps(out, indent=2))
    print(f"  wrote {fp}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=tuple(CELLS) + ("all",),
                    default="all")
    ap.add_argument("--bnn", action="store_true",
                    help="hillclimb a BNN layer mapping over the "
                         "registry candidate space instead of the LM "
                         "scheme cells")
    ap.add_argument("--out", default="results/hillclimb_torch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card's path; the packed BNN weights "
                         "on the card) or cpu")
    args = ap.parse_args(argv)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    if args.bnn:
        run_bnn(outdir, device=args.device)
        return
    cells = tuple(CELLS) if args.cell == "all" else (args.cell,)
    for key in cells:
        run_cell(key, outdir, device=args.device)


__all__ = [
    "CELLS",
    "bnn_mapping_hillclimb",
    "evaluate",
    "main",
    "run_bnn",
    "run_cell",
]


if __name__ == "__main__":
    main()
