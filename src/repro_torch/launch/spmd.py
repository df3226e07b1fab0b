"""A sharded LM step on a real process group — the counterpart of the
JAX package's ``jax.jit`` of a step on ``jax.make_mesh((2, 4), ("data",
"model"))`` over 8 devices (``tests/test_sharding.py``,
``tests/test_runtime_elastic.py``).

Every rank of the group calls the same function with the same whole
tensors (its own copy, made from one seed).  The arguments are placed
as DTensors by ``parallel.sharding``'s plans (``distribute``), the step
runs under ``parallel.constrain.on_mesh``, and what the caller compares
comes back whole (``full_tensor()``, a collective over the mesh).

:func:`run_step` builds its step with ``launch.dryrun.build_step``, the
dry run's own builder, with :func:`real_placement` in place of the fake
one: the real step and the traced one are one program, so the
collectives and matmul FLOPs a ``trace_analysis.StepRecorder`` reads
from a real run equal the dry run's.  :func:`forward` is the model's
whole forward on the same plans (the logits of every position).

A rank outside the mesh (a mesh over some of the world's ranks) must
not call these: its DTensors hold no data.
"""

from __future__ import annotations

from typing import Any, Optional

from repro_torch import configs as C
from repro_torch.launch.dryrun import build_step, step_fn, train_optimizer
from repro_torch.launch.trace_analysis import (
    StepRecorder,
    hide_sharding_propagation,
)
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.constrain import on_mesh
from repro_torch.parallel.sharding import (
    ShardScheme,
    default_scheme,
    distribute,
    make_batch_shardings,
    make_param_shardings,
)
from repro_torch.tree import tree_map

__all__ = [
    "KINDS",
    "forward",
    "full_tensors",
    "local_step",
    "real_placement",
    "run_step",
    "sharded_step",
    "step_cell",
]

KINDS = ("train", "prefill", "decode")


def _fresh_state(specs, shardings):
    """``train_optimizer``'s fresh AdamW state (step 0, zero moments)
    made shard by shard (DTensor's ``zeros``): no rank ever holds the
    whole moments, twice the params' size in f32."""
    from torch.distributed.tensor import zeros

    return tree_map(
        lambda s, sh: zeros(s.shape, dtype=s.dtype, device_mesh=sh.mesh,
                            placements=sh.placements()), specs, shardings)


def real_placement(values: dict):
    """A placement for ``build_step``: ``values[what]`` (whole tensors of
    the specs' structure; a dict may hold more keys than the specs ask
    for) distributed by the step's shardings; the optimizer state, which
    `values` does not hold, fresh (:func:`_fresh_state`)."""
    def place(what, specs, shardings):
        if what == "opt":
            return _fresh_state(specs, shardings)
        tree = values[what]
        if isinstance(specs, dict):
            tree = {k: tree[k] for k in specs}
        return distribute(tree, shardings)

    return place


def full_tensors(tree: Any) -> Any:
    """Each DTensor of `tree` as its whole tensor (a collective over its
    mesh); other leaves as they are."""
    from torch.distributed.tensor import DTensor

    return tree_map(
        lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


def step_cell(cfg: ModelConfig, kind: str, batch: dict) -> C.ShapeCell:
    """The ``ShapeCell`` of a step of `kind` on `batch`: ``{"tokens",
    "labels"[, "frontend_embeds"]}`` (train), ``{"tokens"[,
    "frontend_embeds"]}`` (prefill), ``{"token", "cache"}`` (decode; the
    cell's seq is the cache's length)."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: one of {KINDS}")
    if kind == "decode":
        cache = batch["cache"]
        seq = cache["k"].shape[2] if "k" in cache else int(cache["len"]) + 1
        return C.ShapeCell("spmd", kind, int(seq), batch["token"].shape[0])
    b, t = batch["tokens"].shape
    return C.ShapeCell("spmd", kind, t + cfg.n_frontend_embeds, b)


def _values(cfg: ModelConfig, kind: str, params, batch: dict) -> dict:
    if kind in ("train", "prefill"):
        return {"params": params, "batch": batch}
    return {"params": params, "cache": batch["cache"],
            "token": batch["token"]}


def sharded_step(cfg: ModelConfig, kind: str, mesh,
                 scheme: Optional[ShardScheme], params, batch: dict):
    """The step of :func:`run_step` placed on `mesh`, not yet run:
    ``(run, args)`` of ``launch.dryrun.build_step`` with
    :func:`real_placement`.  Call ``run()`` inside ``on_mesh(mesh,
    scheme)``; it returns DTensors pinned as the dry run pins them."""
    scheme = scheme or default_scheme(cfg)
    return build_step(
        cfg, step_cell(cfg, kind, batch), mesh, scheme,
        place=real_placement(_values(cfg, kind, params, batch)),
        cache_len=(int(batch["cache"]["len"]) if kind == "decode"
                   else None))


def run_step(cfg: ModelConfig, kind: str, mesh,
             scheme: Optional[ShardScheme], params, batch: dict, *,
             recorder: Optional[StepRecorder] = None):
    """One train, prefill or decode step (`kind`) of `cfg` on `mesh`
    under `scheme`, from whole tensors on every rank: `params` (the
    model's tree), `batch` (see :func:`step_cell`; a decode's cache is a
    ``decode_cache``, its ``len`` the tokens it holds).  The train step
    starts from a fresh AdamW state.  Returns the step's outputs whole:
    train ``(params, opt_state, metrics)``, prefill ``(last_logits,
    cache)``, decode ``(logits, cache)`` (the cache without ``len``).
    With `recorder`, the step itself (not the placement, not the
    gathering) runs inside it, as ``dryrun.dry_run`` records it."""
    scheme = scheme or default_scheme(cfg)
    run, _ = sharded_step(cfg, kind, mesh, scheme, params, batch)
    with on_mesh(mesh, scheme):
        if recorder is None:
            out = run()
        else:
            with recorder, hide_sharding_propagation(recorder):
                out = run()
        return full_tensors(out)


def local_step(cfg: ModelConfig, kind: str, params, batch: dict,
               scheme: Optional[ShardScheme] = None):
    """:func:`run_step`'s step on plain tensors, no mesh (what a sharded
    step is held to).  A decode updates ``batch["cache"]`` in place."""
    scheme = scheme or default_scheme(cfg)
    step = step_fn(cfg, kind, scheme)
    if kind == "train":
        return step(params, train_optimizer(cfg).init(params), batch)
    if kind == "prefill":
        return step(params, batch["tokens"], batch.get("frontend_embeds"))
    logits, cache = step(params, batch["cache"], batch["token"])
    return logits, {k: v for k, v in cache.items() if k != "len"}


def forward(cfg: ModelConfig, mesh, scheme: Optional[ShardScheme], params,
            tokens):
    """``models.transformer.forward`` on `mesh`: `params` placed by
    ``make_param_shardings``, the tokens by ``make_batch_shardings``;
    returns the whole logits and aux loss."""
    from repro_torch.models import transformer

    scheme = scheme or default_scheme(cfg)
    batch = distribute({"tokens": tokens}, make_batch_shardings(
        cfg, mesh, {"tokens": tokens}, scheme))
    p = distribute(params, make_param_shardings(cfg, mesh, params, scheme))
    with on_mesh(mesh, scheme):
        logits, _, aux = transformer.forward(cfg, p, batch["tokens"])
        return full_tensors((logits, aux))
