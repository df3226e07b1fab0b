#!/usr/bin/env python3
"""How far bf16 drifts from f32 in an LM of ``repro_torch.configs`` on one
card, and where the teacher-forced decode path stands inside that drift.

    python3 tools/lm_bf16_drift.py --arch zamba2_7b [--layers N]
        [--batch 2] [--prompt 512] [--steps 16] [--json PATH]

Seeded random weights are drawn in f32 on the card (``--layers`` cuts
the depth, for a model whose f32 weights do not fit beside its bf16
copy); the bf16 weights are their roundings.  For the last ``--steps``
positions of a ``--prompt``-token sequence (NumPy seed 0) it computes
the logits of:

- ``full32``: the f32 full forward with the plain attention (the truth);
- ``dec32``: the f32 teacher-forced path (prefill through the flash
  kernel, then one decode step per position);
- ``full16`` and ``dec16``: the same two in bf16,

and prints each one's relative max error (max |a - b| over max |b|)
against ``full32``, and ``dec16`` against ``full16`` (the quantity
``chip_smoke.py`` phase 4d holds), per position and over all.  For an
MoE config it also prints, per layer, the share of (token, layer)
top-k sets on which ``dec16`` and ``full16`` agree, and ``full16`` and
``full32``.  Run it on a machine with an NVIDIA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import modules, steps
    from repro_torch.models import transformer as lm

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lm_bf16_drift: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if cfg.moe:   # nothing dropped on either path
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=chip_smoke.TF_CAPACITY))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    B, P, n = args.batch, args.prompt, args.steps
    p0 = P - n
    seq = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, P - 1))).to(dev)
    plain = modules.chunked_attention_plain

    def full(c, params):
        with chip_smoke.routing_recorded() as rec:
            logits, _, _ = lm.forward(c, params, seq, attention=plain)
        return logits[:, p0 - 1:], rec

    def teacher_forced(c, params):
        serve = steps.make_serve_step(c)
        with chip_smoke.routing_recorded() as rec:
            last, cache = steps.make_prefill_step(c)(params, seq[:, :p0])
            cache = steps.decode_cache(c, cache, P, device=dev)
            out = [last]
            for t in range(n - 1):
                logits, cache = serve(params, cache, seq[:, p0 + t:p0 + t + 1])
                out.append(logits)
        return torch.stack(out, dim=1), rec

    def rel(a, b):
        per_pos = ((a - b).abs().amax(-1) / b.abs().amax()).amax(0)
        return {"all": float(per_pos.max()),
                "per_position": [round(float(x), 6) for x in per_pos]}

    def agreement(rec_a, rec_b):
        L = cfg.n_layers
        a = chip_smoke.topk_sets([rec_a[i::L] for i in range(L)], B)
        b = chip_smoke.topk_sets([rec_b[i::L] for i in range(L)], B)
        return [round(float((x == y).all(-1).float().mean()), 4)
                for x, y in zip(a, b)]

    p32 = lm.init_params(cfg32, torch.Generator(device=dev).manual_seed(0),
                         dev)
    full32, rec32 = full(cfg32, p32)
    dec32, _ = teacher_forced(cfg32, p32)
    p16 = chip_smoke.tree_to(p32, torch.bfloat16)
    del p32
    torch.cuda.empty_cache()
    full16, rec_full16 = full(cfg, p16)
    dec16, rec_dec16 = teacher_forced(cfg, p16)
    res = {
        "arch": args.arch, "layers": cfg.n_layers, "batch": B, "prompt": P,
        "steps": n, "device": chip_smoke.smi("name,power.limit"),
        "dec32_vs_full32": rel(dec32, full32),
        "full16_vs_full32": rel(full16, full32),
        "dec16_vs_full32": rel(dec16, full32),
        "dec16_vs_full16": rel(dec16, full16),
        "argmax_dec16_vs_full16": float(
            (dec16.argmax(-1) == full16.argmax(-1)).float().mean()),
    }
    if cfg.moe:
        res["routing_dec16_vs_full16"] = agreement(rec_dec16, rec_full16)
        res["routing_full16_vs_full32"] = agreement(rec_full16, rec32)
    for key, val in res.items():
        print(f"{key}: {val}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
