"""The port's dry run (``repro_torch.launch.dryrun``) held to torch
itself, on CPU tensors and fake process groups: the traced per-device
FLOPs of a step on a 1 x 1 mesh equal ``FlopCounterMode``'s over the
same step run for real on plain CPU tensors, exactly (the check phase 16
of ``chip_smoke.py`` makes at full width on the card), for the default
train step (each layer rematerialised, ``cfg.remat``) and for the one
without remat; a 1 x 1 mesh emits no collective; a data-parallel mesh
splits the FLOPs evenly; and head counts a wide 'model' axis does not
divide still trace."""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as T_C  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    fake_process_group,
    make_debug_mesh,
)
from repro_torch.models import steps as T_S  # noqa: E402
from repro_torch.models import transformer as T_T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402




def _real_step_flops(cfg, kind, B, S) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    g = torch.Generator().manual_seed(0)
    params = T_T.init_params(cfg, g, device="cpu")
    nf = cfg.n_frontend_embeds
    toks = torch.randint(0, cfg.vocab, (B, S - nf), generator=g,
                         dtype=torch.int32)
    fe = (torch.randn(B, nf, cfg.d_model, generator=g).to(
        getattr(torch, cfg.dtype)) if nf else None)
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            opt = adamw(3e-4)
            batch = {"tokens": toks, "labels": toks}
            if fe is not None:
                batch["frontend_embeds"] = fe
            T_S.make_train_step(cfg, opt, grad_compression="bf16")(
                params, opt.init(params), batch)
        else:
            T_S.make_prefill_step(cfg)(params, toks, fe)
    return fc.get_total_flops()


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "olmo_1b",
                                  "deepseek_moe_16b", "mamba2_130m",
                                  "zamba2_7b", "musicgen_medium"])
def test_one_by_one_flops_equal_flop_counter_on_the_real_step(arch, kind):
    cfg = T_C.get_smoke(arch)
    B, S = 4, 64
    with fake_process_group(1):
        mesh = make_debug_mesh((1, 1), ("data", "model"), device_type="cpu")
        r = D.dry_run(cfg, T_C.ShapeCell("t", kind, S, B), mesh,
                      device="cpu")
    assert r["collectives"]["per_device_bytes"] == 0.0
    assert r["collectives"]["by_kind_count"] == {}
    assert r["per_device"]["hlo_flops"] == _real_step_flops(cfg, kind, B, S)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "olmo_1b",
                                  "deepseek_moe_16b", "mamba2_130m",
                                  "zamba2_7b", "musicgen_medium"])
def test_one_by_one_flops_equal_flop_counter_without_remat(arch):
    """The train step with ``remat=False`` (no layer recompute) beside
    the default remat step above: both programs stay held."""
    cfg = dataclasses.replace(T_C.get_smoke(arch), remat=False)
    B, S = 4, 64
    with fake_process_group(1):
        mesh = make_debug_mesh((1, 1), ("data", "model"), device_type="cpu")
        r = D.dry_run(cfg, T_C.ShapeCell("t", "train", S, B), mesh,
                      device="cpu")
    assert r["per_device"]["hlo_flops"] == _real_step_flops(
        cfg, "train", B, S)


def test_sharded_flops_split_over_the_mesh():
    """olmo's smoke prefill under pure data parallelism on a 4 x 1 mesh:
    each device computes a quarter of the 1 x 1 step's FLOPs."""
    cfg = T_C.get_smoke("olmo_1b")
    cell = T_C.ShapeCell("t", "prefill", 64, 8)
    flops = {}
    for shape in ((1, 1), (4, 1)):
        with fake_process_group(shape[0] * shape[1]):
            mesh = make_debug_mesh(shape, ("data", "model"),
                                   device_type="cpu")
            flops[shape] = D.dry_run(cfg, cell, mesh, device="cpu")[
                "per_device"]["hlo_flops"]
    assert flops[(4, 1)] * 4 == flops[(1, 1)]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["llava_next_mistral_7b", "grok_1_314b",
                                  "mamba2_130m"])
def test_head_counts_a_wide_model_axis_does_not_divide(arch, kind):
    """A 16-wide 'model' axis over the smoke configs' 4 heads (8 SSD
    heads): the head splits replicate what does not divide
    (``split_dim``), as qwen2.5's 40 heads over 16 need at full size."""
    cfg = T_C.get_smoke(arch)
    with fake_process_group(32):
        mesh = make_debug_mesh((2, 16), ("data", "model"),
                               device_type="cpu")
        r = D.dry_run(cfg, T_C.ShapeCell("t", kind, 64, 4), mesh,
                      device="cpu")
    assert r["per_device"]["hlo_flops"] > 0
    assert r["memory"]["peak_bytes_per_device"] > 0


def _loss_head(monkeypatch, cfg, scheme, cell) -> tuple:
    """The matmul FLOPs a device spends in the forward's loss head
    (``transformer._unembed``) over one dry-run train step, the
    recorder's count read before and after each call, and the
    placements of the tokens each micro-step's ``loss_fn`` gets."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    from repro_torch.launch.trace_analysis import StepRecorder

    spent, seen = [], []
    unembed, loss_fn = T_T._unembed, T_S.loss_fn

    def counted(*args, **kwargs):
        rec = next(m for m in _get_current_dispatch_mode_stack()
                   if isinstance(m, StepRecorder))
        before = rec.dot_flops
        out = unembed(*args, **kwargs)
        spent.append(rec.dot_flops - before)
        return out

    def spy(cfg_, params, tokens, *args, **kwargs):
        seen.append(tuple(tokens.placements))
        return loss_fn(cfg_, params, tokens, *args, **kwargs)

    monkeypatch.setattr(T_T, "_unembed", counted)
    monkeypatch.setattr(T_S, "loss_fn", spy)
    with fake_process_group(8):
        mesh = make_debug_mesh((2, 4), ("data", "model"), device_type="cpu")
        D.dry_run(cfg, cell, mesh, scheme, device="cpu")
    monkeypatch.setattr(T_T, "_unembed", unembed)
    monkeypatch.setattr(T_S, "loss_fn", loss_fn)
    assert len(spent) == len(seen) == scheme.accum_steps
    return sum(spent), set(seen)


@pytest.mark.parametrize("batch_over_model", [False, True])
def test_accumulated_micro_batches_keep_the_loss_head_sharded(
        monkeypatch, batch_over_model):
    """``accum_steps=4`` on a fake (2, 4) group: each micro-batch reaches
    ``loss_fn`` sharded as the whole batch is (``pin_batch`` on each
    slice: a slice of a batch-sharded DTensor comes back replicated),
    and the loss head costs a device what it costs at ``accum_steps=1``.
    (Its matmul FLOPs were equal before the pin too: the residual pin
    after the embedding re-shards the rows.  What the replicated slice
    cost was memory: deepseek's ``ep+accum4`` train_4k cell held a
    replicated micro-batch's f32 logits.)"""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel.sharding import ShardScheme

    cfg = T_C.get_smoke("olmo_1b")
    cell = T_C.ShapeCell("t", "train", 16, 32)
    got = {
        n: _loss_head(monkeypatch, cfg, ShardScheme(
            tp=True, fsdp="zero1", batch_over_model=batch_over_model,
            accum_steps=n), cell)
        for n in (1, 4)}
    rows = (Shard(0), Shard(0)) if batch_over_model else (Shard(0),
                                                          Replicate())
    assert got[1][1] == got[4][1] == {rows}
    assert got[1][0] > 0
    assert got[4][0] == got[1][0]
