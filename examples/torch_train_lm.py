"""End-to-end LM training driver on PyTorch and CUDA (the port of
``examples/train_lm.py``): any assigned architecture (reduced or full),
synthetic k-gram token stream, AdamW + cosine schedule, atomic
checkpoints with exact resume, straggler watchdog.

    PYTHONPATH=src python examples/torch_train_lm.py --arch qwen2_0_5b \\
        --steps 60 --batch 8 --seq 128
    # kill it mid-run and re-run: it resumes from the latest checkpoint
    # (--ckpt sets the checkpoint dir, default results/torch_train_lm_ckpt)
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 5

    --full uses the exact assigned config (for the card; the smoke
    config is the default).

The step is the eager one (``models.steps.make_train_step``); on the
card its attention runs the flash attention kernel, once per layer in
the forward and once more per layer where the remat reruns it.  Weights
are random, from a generator seeded 0 on the device.
"""

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


def main(argv=None, *, params=None) -> dict:
    """Train; returns ``cfg``, ``loop`` (its ``state`` is the final
    ``(params, opt_state)``), ``resumed`` (the checkpoint step it
    resumed from, 0 for none), ``metrics`` (one dict a step run:
    ``step``, ``sec``, ``loss``, ``grad_norm``, ...), ``first`` /
    ``last`` (the first and last of them) and ``final_step``.

    `params` (keyword only): the model's parameters on the device, in
    place of ``init_params`` from a generator seeded 0 (the tests carry
    the JAX package's across)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt", default="results/torch_train_lm_ckpt")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = C.get(args.arch) if args.full else C.get_smoke(args.arch)
    print(f"arch={cfg.name}  params={cfg.n_params()/1e6:.1f}M")
    if params is None:
        params = init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    opt = adamw(linear_warmup_cosine(3e-3, 10, args.steps))
    opt_state = opt.init(params)
    raw_step = make_train_step(cfg, opt)
    sample = make_token_stream(SEED, cfg.vocab)

    def step_fn(state, batch):
        params, opt_state = state
        params, opt_state, metrics = raw_step(params, opt_state, batch)
        return (params, opt_state), metrics

    def batch_fn(step):
        toks = sample(step, args.batch, args.seq).to(dev)
        batch = {"tokens": toks, "labels": toks}
        if cfg.n_frontend_embeds:
            batch["frontend_embeds"] = torch.zeros(
                (args.batch, cfg.n_frontend_embeds, cfg.d_model),
                dtype=getattr(torch, cfg.dtype), device=dev,
            )
        return batch

    loop = TrainLoop(
        step_fn, batch_fn, (params, opt_state),
        LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                   save_every=20, async_save=True),
        on_straggler=lambda s, dt: print(f"  [watchdog] slow step {s}: {dt:.2f}s"),
    )
    resumed = loop.restore_if_available()
    if resumed:
        print(f"resumed from checkpoint at step {resumed}")
    out = loop.run()
    first = out["metrics"][0] if out["metrics"] else {}
    last = out["metrics"][-1] if out["metrics"] else {}
    print(
        f"steps {loop.start_step}->{out['final_step']}  "
        f"loss {first.get('loss', float('nan')):.3f} -> "
        f"{last.get('loss', float('nan')):.3f}"
    )
    return {"cfg": cfg, "loop": loop, "resumed": resumed,
            "metrics": out["metrics"], "first": first, "last": last,
            "final_step": out["final_step"]}


if __name__ == "__main__":
    main()
