"""Serving launcher: prefill a batch of prompts, then decode tokens
autoregressively with the KV / SSM cache (greedy).  Every arch of
``repro_torch.configs`` serves: the attention families, ``moe``
(deepseek_moe_16b, grok_1_314b), ``ssm`` (mamba2_130m) and ``hybrid``
(zamba2_7b).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_7b \\
        --full --batch 4 --prompt-len 2048 --gen 32        # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_130m \\
        --device cpu                                       # smoke config

Weights are random, from ``torch.Generator`` seed ``--seed`` on the
device; prompts from NumPy seed ``--seed + 1``.  It runs on the card
unless ``--device cpu`` is given, and raises without one.  At full
width deepseek_moe_16b takes 33.8 GB of bf16 weights and zamba2_7b
13.5 GB; grok_1_314b (633 GB) does not fit one card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.device import resolve_device
from repro_torch.models.steps import greedy_decode
from repro_torch.models.transformer import init_params


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = C.get(args.arch) if args.full else C.get_smoke(args.arch)
    print(f"arch={cfg.name} params={cfg.n_params()/1e6:.1f}M device={dev}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    prompt = np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab, (args.batch, args.prompt_len))
    if dev.type == "cuda":   # build the kernels before the clock starts
        from repro_torch.kernels import build

        build.load_library("flash_attention")
    stats: dict = {}
    t0 = time.perf_counter()
    toks = greedy_decode(
        cfg, params, prompt, n_steps=args.gen,
        max_len=args.prompt_len + args.gen, device=dev, stats=stats,
    )
    dt = time.perf_counter() - t0
    n = args.batch * args.gen
    per_tok = stats["decode_s"] / max(stats["decode_steps"], 1)
    print(f"generated {n} tokens in {dt:.3f}s ({n / dt:.1f} tok/s, first "
          f"call); prefill {stats['prefill_s'] * 1e3:.3f} ms, decode "
          f"{per_tok * 1e3:.3f} ms/token")
    print("sample:", toks[0, :12].tolist())
    return {"tokens": toks, "seconds": dt, **stats}


if __name__ == "__main__":
    main()
