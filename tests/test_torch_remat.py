"""Per-layer rematerialisation (``cfg.remat``) in the port's LM train
step, on the CPU at smoke size, against the JAX package's
``jax.checkpoint`` of its scanned layer bodies
(``repro.models.transformer``).

- Values: the port's loss, ce, aux and every gradient leaf with
  ``remat=True`` are ``torch.equal`` to those with ``remat=False`` (the
  recompute runs the same CPU ops on the same inputs; the MoE dispatch's
  accumulating ``index_put_`` is deterministic on the CPU), and both are
  held to the reference's ``jax.value_and_grad`` (its config has
  ``remat=True``) within ``tests/_torch_lm_train.py``'s tolerances.
- Placement: the layer bodies a train forward plus backward runs, by a
  counting wrapper patched in here: every attention and Mamba layer
  twice (forward and recompute), the hybrid's weight-shared attention
  block once per segment (the reference does not checkpoint it);
  prefill and decode under ``no_grad`` once per layer.
- Saved activations: bytes autograd saves outside the checkpointed
  bodies (``saved_tensors_hooks``), which with remat are exactly the
  non-layer part.
- The dry run traces the remat step on a fake 1 x 1 and 2 x 4 mesh; on
  1 x 1 its FLOPs rise by exactly what ``FlopCounterMode`` counts in
  the bodies the backward reruns, and its predicted peak falls on both.
- The reference's own FLOP rise: its ``make_train_step`` jitted with
  ``remat`` True and False and its dots counted by
  ``repro.launch.hlo_analysis.dot_flops``.  The two rises are held
  equal, exactly, once two known differences are taken out.  (1) The
  reference's chunked attention also checkpoints each query chunk with
  ``remat_chunks=cfg.remat``, so its remat step computes each attention
  forward twice more: once in the layer's recompute and once in the
  chunk's.  The port recomputes the chunks in both steps
  (``FlashAttentionFn``'s backward), so its rise holds the layer
  recompute only.  (2) XLA counts every block of the dense attention
  product, ``4 B H S^2 D``.  The port's attention op counts only the
  pairs that causal masking leaves visible (``flash_flops``).  Both
  recomputes skip the layer's last matmul: the backward needs its
  input, not its output.  The port's non-reentrant checkpoint stops
  there, and XLA drops the dead product.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_lm_train as H  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.autograd.graph import saved_tensors_hooks  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as R_C  # noqa: E402
from repro import optim as R_optim  # noqa: E402
from repro.launch.hlo_analysis import dot_flops  # noqa: E402
from repro.models import steps as R_S  # noqa: E402
from repro.models import transformer as R_T  # noqa: E402
from repro_torch import configs as T_C  # noqa: E402
from repro_torch.kernels.flash_attention import flash_flops  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    fake_process_group,
    make_debug_mesh,
)
from repro_torch.models import steps as T_S  # noqa: E402
from repro_torch.models import transformer as T_T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.constrain import scheme_context  # noqa: E402
from repro_torch.parallel.sharding import ShardScheme  # noqa: E402
from repro_torch.tree import flatten, leaves, paths, unflatten  # noqa: E402

# dense, MoE, SSM, hybrid and a front end (image embeds prepended)
FAMILIES = ("qwen2_0_5b", "deepseek_moe_16b", "mamba2_130m", "zamba2_7b",
            "llava_next_mistral_7b")
B, S = 4, 64


def _cfg(arch: str, remat: bool):
    return dataclasses.replace(T_C.get_smoke(arch), remat=remat)


def _seeded(cfg, batch: int = B, seq: int = S):
    g = torch.Generator().manual_seed(0)
    params = T_T.init_params(cfg, g, device="cpu")
    nf = cfg.n_frontend_embeds
    toks = torch.randint(0, cfg.vocab, (batch, seq - nf), generator=g,
                         dtype=torch.int32)
    fe = torch.randn(batch, nf, cfg.d_model, generator=g) if nf else None
    return params, toks, fe


def _n_attn(cfg) -> int:
    """Attention applications of a forward: the layers, or the hybrid's
    shared block once per segment."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return T_T._hybrid_split(cfg)[1]
    return cfg.n_layers


def _n_mamba(cfg) -> int:
    return cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0


@contextlib.contextmanager
def _counting(monkeypatch, on_call=None):
    """Count calls of the two layer bodies; ``on_call(kind, fn)`` may
    wrap each call."""
    calls = {"attn": 0, "mamba": 0}

    def wrap(kind, fn):
        def run(*args, **kwargs):
            calls[kind] += 1
            if on_call is None:
                return fn(*args, **kwargs)
            return on_call(kind, lambda: fn(*args, **kwargs))
        return run

    monkeypatch.setattr(T_T, "attn_block_apply",
                        wrap("attn", T_T.attn_block_apply))
    monkeypatch.setattr(T_T, "mamba_block_apply",
                        wrap("mamba", T_T.mamba_block_apply))
    yield calls


def _train_fwd_bwd(cfg, params, toks, fe):
    flat, tdef = flatten(params)
    live = [t.detach().requires_grad_() for t in flat]
    loss, _ = T_S.loss_fn(cfg, unflatten(tdef, live), toks, toks, fe)
    torch.autograd.grad(loss, live, allow_unused=True)


# -- values ------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_step_equals_the_plain_step_and_the_reference(arch):
    """Both packages start from the port's seeded params (the JAX
    package's eager ``init_params`` costs seconds per config)."""
    cfg = R_C.get_smoke(arch)
    assert cfg.remat
    p0, _, _ = _seeded(T_C.get_smoke(arch))
    params = jax.tree.map(jnp.asarray, T_T.params_to_numpy(p0))
    b = H.make_batch(cfg, 2, 10)
    (loss, (ce, aux)), g = H._jax_loss(cfg)(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    want = H._np_leaves(g)
    got = {r: H.port_loss_and_grads(_cfg(arch, r), p0, b)
           for r in (True, False)}
    assert got[True][:3] == got[False][:3]
    names = paths(p0)
    for name, a, c in zip(names, got[True][3], got[False][3]):
        assert torch.equal(a, c), name
    for r, (l_, c_, a_, grads) in got.items():
        for x, w in zip((l_, c_, a_), (loss, ce, aux)):
            assert H.rel(x, float(w)) <= H.REL_METRIC, (r, x, float(w))
        assert len(grads) == len(want)
        for name, gr, w in zip(names, grads, want):
            assert H.leaf_rel(gr.numpy(), w) <= H.REL_GRAD, (r, name)


@pytest.mark.parametrize("arch", ["qwen2_0_5b"])
def test_recompute_runs_in_the_forward_context(arch):
    """The autograd engine runs a CUDA backward on its own device
    thread, which sees none of the caller's context variables.  A
    forward under ``scheme_context(attn_kv_parallel=True)`` takes the
    context-parallel attention; its backward, on the calling thread
    after the block and on a new thread, must recompute the same
    attention and give the gradient of the plain step's backward inside
    the block."""
    params, toks, _ = _seeded(_cfg(arch, True), batch=2, seq=32)
    kv = ShardScheme(attn_kv_parallel=True)

    def forward(remat):
        flat, tdef = flatten(params)
        live = [t.detach().requires_grad_() for t in flat]
        with scheme_context(kv):
            loss, _ = T_S.loss_fn(_cfg(arch, remat), unflatten(tdef, live),
                                  toks, toks)
            if not remat:
                return torch.autograd.grad(loss, live)
        return loss, live

    want = forward(False)
    here = torch.autograd.grad(*forward(True))
    loss, live = forward(True)
    out = {}
    t = threading.Thread(
        target=lambda: out.update(g=torch.autograd.grad(loss, live)))
    t.start()
    t.join()
    for got in (here, out["g"]):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


# -- placement ---------------------------------------------------------------


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_reruns_the_bodies_the_reference_checkpoints(
        arch, remat, monkeypatch):
    cfg = _cfg(arch, remat)
    params, toks, fe = _seeded(cfg)
    with _counting(monkeypatch) as calls:
        _train_fwd_bwd(cfg, params, toks, fe)
    twice = 2 if remat else 1
    assert calls["mamba"] == twice * _n_mamba(cfg)
    if cfg.family == "hybrid":      # the shared block is never rerun
        assert calls["attn"] == _n_attn(cfg)
    else:
        assert calls["attn"] == twice * _n_attn(cfg)


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad_on"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_run_each_layer_once(arch, grad, monkeypatch):
    """Under ``no_grad``, and with autograd on but nothing to
    differentiate (``greedy_decode``'s prefill), no layer goes through
    a checkpoint."""
    cfg = _cfg(arch, True)
    params, toks, fe = _seeded(cfg, batch=2, seq=16)
    checkpoints = []
    monkeypatch.setattr(T_T, "checkpoint",
                        lambda *a, **k: checkpoints.append(a))
    with _counting(monkeypatch) as calls, torch.set_grad_enabled(grad):
        _, cache = T_S.make_prefill_step(cfg)(params, toks, fe)
        assert calls == {"attn": _n_attn(cfg), "mamba": _n_mamba(cfg)}
        full = T_S.decode_cache(cfg, cache, 24, device="cpu")
        T_S.make_serve_step(cfg)(params, full, toks[:, -1:])
    assert calls == {"attn": 2 * _n_attn(cfg), "mamba": 2 * _n_mamba(cfg)}
    assert checkpoints == []


# -- saved activations -------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_saves_only_the_non_layer_part(arch, monkeypatch):
    """Unique storage bytes autograd saves during a train forward, params
    and batch left out.  Without remat, the bytes saved inside the layer
    bodies are told apart by a flag the counting wrapper sets; with
    remat, checkpoint's own hooks take the bodies' tensors, and what is
    left is the non-layer part plus each checkpointed layer's input (the
    residual stream, which checkpoint keeps to rerun the layer): every
    layer of the stack here, the hybrid's shared block aside.  That is
    strictly below the plain step's."""
    saved = {}
    for remat in (True, False):
        cfg = _cfg(arch, remat)
        params, toks, fe = _seeded(cfg)
        flat, tdef = flatten(params)
        live = [t.detach().requires_grad_() for t in flat]
        skip = {t.untyped_storage()._cdata for t in live + [toks]}
        seen, depth = {}, [0]

        def pack(t):
            st = t.untyped_storage()
            if st._cdata not in skip and st._cdata not in seen:
                # the storage is held, so its address is not reused
                seen[st._cdata] = (st.nbytes(), depth[0] > 0, st)
            return t

        def inside(kind, run):
            if kind == "attn" and cfg.family == "hybrid":
                return run()        # the shared block: never checkpointed
            depth[0] += 1
            try:
                return run()
            finally:
                depth[0] -= 1

        with _counting(monkeypatch, inside), \
                saved_tensors_hooks(pack, lambda t: t):
            loss, _ = T_S.loss_fn(cfg, unflatten(tdef, live), toks, toks,
                                  fe)
        saved[remat] = (sum(n for n, _, _ in seen.values()),
                        sum(n for n, body, _ in seen.values() if body))
        del loss
        monkeypatch.undo()
    total, in_bodies = saved[False]
    non_layer = total - in_bodies
    residual = B * S * cfg.d_model * torch.finfo(
        getattr(torch, cfg.dtype)).bits // 8
    assert in_bodies > 0
    assert saved[True][1] == 0
    assert saved[True][0] < total
    assert saved[True][0] == non_layer + cfg.n_layers * residual


# -- the dry run -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dry(arch: str, remat: bool, shape: tuple) -> tuple:
    """(per-device FLOPs, predicted peak) of the smoke train step's dry
    run, once per process."""
    cfg = _cfg(arch, remat)
    with fake_process_group(shape[0] * shape[1]):
        mesh = make_debug_mesh(shape, ("data", "model"), device_type="cpu")
        r = D.dry_run(cfg, T_C.ShapeCell("t", "train", S, B), mesh,
                      device="cpu")
    return r["per_device"]["hlo_flops"], r["memory"]["peak_bytes_per_device"]


def _recomputed_flops(cfg, monkeypatch) -> int:
    """``FlopCounterMode``'s FLOPs inside the layer bodies that run
    during the backward (the recompute) of the real remat step on plain
    CPU tensors."""
    params, toks, fe = _seeded(cfg)
    opt = adamw(3e-4)
    batch = {"tokens": toks, "labels": toks}
    if fe is not None:
        batch["frontend_embeds"] = fe
    got = [0]

    with FlopCounterMode(display=False) as fc:
        def in_backward(kind, run):
            if torch._C._current_graph_task_id() == -1:
                return run()
            before = fc.get_total_flops()
            try:
                return run()
            finally:
                got[0] += fc.get_total_flops() - before

        with _counting(monkeypatch, in_backward) as calls:
            T_S.make_train_step(cfg, opt, grad_compression="bf16")(
                params, opt.init(params), batch)
    assert calls["attn"] + calls["mamba"] > cfg.n_layers
    return got[0]


@pytest.mark.parametrize("arch", ["qwen2_0_5b"])
def test_dry_run_on_one_by_one_rises_by_the_recomputed_layers(
        arch, monkeypatch):
    on, off = _dry(arch, True, (1, 1)), _dry(arch, False, (1, 1))
    rise = on[0] - off[0]
    assert rise > 0
    assert rise == _recomputed_flops(_cfg(arch, True), monkeypatch)
    assert on[1] < off[1]


def test_dry_run_on_a_two_by_four_mesh_traces_the_remat_step():
    """qwen2's smoke train step on a 2 x 4 DTensor mesh: it traces with
    the checkpoint replaying ``parallel.constrain``'s pins; the
    per-device rise lies between an eighth of the 1 x 1 rise (all of it
    sharded) and a half (the batch alone split over 'data'); the peak
    falls."""
    on = _dry("qwen2_0_5b", True, (2, 4))
    off = _dry("qwen2_0_5b", False, (2, 4))
    rise = on[0] - off[0]
    one = _dry("qwen2_0_5b", True, (1, 1))[0] - _dry(
        "qwen2_0_5b", False, (1, 1))[0]
    assert one / 8 <= rise <= one / 2
    assert on[1] < off[1]


# -- the reference's FLOP rise -------------------------------------------------


# the hybrid cut to 4 layers (one segment of 3 Mamba layers, the shared
# block, one tail layer): XLA's compile time grows with depth
DEPTH = {"zamba2_7b": 4}


def _jax_train_dot_flops(arch: str, remat: bool) -> float:
    cfg = R_C.get_smoke(arch)
    cfg = dataclasses.replace(cfg, remat=remat,
                              n_layers=DEPTH.get(arch, cfg.n_layers))
    params = jax.eval_shape(
        lambda: R_T.init_params(cfg, jax.random.PRNGKey(0)))
    opt = R_optim.adamw(3e-4)
    nf = cfg.n_frontend_embeds
    tok = jax.ShapeDtypeStruct((B, S - nf), jnp.int32)
    batch = {"tokens": tok, "labels": tok}
    if nf:
        batch["frontend_embeds"] = jax.ShapeDtypeStruct(
            (B, nf, cfg.d_model), jnp.dtype(cfg.dtype))
    step = R_S.make_train_step(cfg, opt, grad_compression="bf16")
    lowered = jax.jit(step).lower(params, jax.eval_shape(opt.init, params),
                                  batch)
    return dot_flops(lowered.compile().as_text())


def _port_train_flops(cfg) -> int:
    params, toks, fe = _seeded(cfg)
    opt = adamw(3e-4)
    batch = {"tokens": toks, "labels": toks}
    if fe is not None:
        batch["frontend_embeds"] = fe
    with FlopCounterMode(display=False) as fc:
        T_S.make_train_step(cfg, opt, grad_compression="bf16")(
            params, opt.init(params), batch)
    return fc.get_total_flops()


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "zamba2_7b"])
def test_flop_rise_matches_the_reference_rise(arch):
    ref = _jax_train_dot_flops(arch, True) - _jax_train_dot_flops(
        arch, False)
    cfg = T_C.get_smoke(arch)
    cfg = dataclasses.replace(cfg, n_layers=DEPTH.get(arch, cfg.n_layers))
    port = _port_train_flops(dataclasses.replace(cfg, remat=True)) - (
        _port_train_flops(dataclasses.replace(cfg, remat=False)))
    assert S <= min(cfg.attn_q_chunk, cfg.attn_kv_chunk)   # one block
    dense = 4 * B * cfg.n_heads * S * S * cfg.hd
    causal = flash_flops((B, cfg.n_heads, S, cfg.hd),
                         (B, cfg.n_kv_heads, S, cfg.hd), True, 0)
    if cfg.family == "hybrid":
        # the shared block: no layer recompute in either; the
        # reference's query-chunk checkpoint reruns its attention
        extra = _n_attn(cfg) * dense
    else:
        extra = _n_attn(cfg) * (2 * dense - causal)
    assert port > 0
    assert port == ref - extra, (port, ref, extra)
