"""Training launcher: train an LM of ``repro_torch.configs`` on the
synthetic token stream with AdamW under the fault-tolerant loop (the
counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b \\
        --full --steps 20 --batch 4 --seq 2048          # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \\
        --steps 5 --device cpu                          # smoke config

Weights are random, from a ``torch.Generator`` seeded 0 on the device;
the tokens come from ``make_token_stream(0, vocab)``, so a relaunch
resumes from the latest checkpoint in ``--ckpt`` and replays nothing.
It runs on the card unless ``--device cpu`` is given, and raises without
one.  At full width AdamW keeps two float32 moments per parameter:
qwen2-0.5B's state is about 5 GB, and each checkpoint writes all of it.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import configs as C
from repro_torch.data import make_token_stream
from repro_torch.device import resolve_device
from repro_torch.models.steps import make_train_step
from repro_torch.models.transformer import init_params
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.runtime import LoopConfig, TrainLoop

SEED = 0


def main(argv=None) -> dict:
    """Returns ``{"cfg", "loop", "out"}``: the config, the ``TrainLoop``
    (its ``state`` is the final ``(params, opt_state)``) and what its
    ``run()`` returned."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="use the full assigned config")
    ap.add_argument("--ckpt", default="results/train_ckpt")
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = C.get(args.arch) if args.full else C.get_smoke(args.arch)
    print(f"arch={cfg.name} params={cfg.n_params()/1e6:.1f}M device={dev}")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    opt = adamw(linear_warmup_cosine(args.lr, 10, args.steps))
    raw = make_train_step(cfg, opt, accum_steps=args.accum)
    sample = make_token_stream(SEED, cfg.vocab)

    def step_fn(state, batch):
        p, o = state
        p, o, m = raw(p, o, batch)
        return (p, o), m

    def batch_fn(step):
        toks = sample(step, args.batch, args.seq).to(dev)
        b = {"tokens": toks, "labels": toks}
        if cfg.n_frontend_embeds:
            b["frontend_embeds"] = torch.zeros(
                (args.batch, cfg.n_frontend_embeds, cfg.d_model),
                dtype=getattr(torch, cfg.dtype), device=dev)
        return b

    loop = TrainLoop(
        step_fn, batch_fn, (params, opt.init(params)),
        LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                   save_every=args.save_every, async_save=True),
    )
    loop.restore_if_available()
    out = loop.run()
    last = out["metrics"][-1] if out["metrics"] else {}
    print(f"done at step {out['final_step']}; "
          f"final loss {last.get('loss', float('nan')):.4f}")
    return {"cfg": cfg, "loop": loop, "out": out}


if __name__ == "__main__":
    main()
