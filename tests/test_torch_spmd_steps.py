"""The port's sharded train steps on a real world of 8 ranks
(``launch.spmd.run_step``, the dry run's own ``build_step`` with real
tensors placed by ``distribute``), and the dry run held to that world.

One ``launch.mesh.spawn_world`` of 8 ``gloo`` processes on the CPU runs
every case of this module from a module-scoped fixture with its own
timeout (``tests/_torch_spmd.py`` holds the rank bodies); each case is
a test of its own.  Params are the JAX package's ``init_params(
PRNGKey(0))`` on the smoke configs, carried across as NumPy.

* Training: one AdamW step (bf16 gradient compression) at
  ``accum_steps`` 1 and 4 on (2, 4) under ``ShardScheme(tp=True,
  fsdp="zero1")``, once more with ``attn_kv_parallel`` (the
  context-parallel attention's backward on sharded tensors): loss, ce
  and grad_norm within ``REL = 1e-5``
  of the port's local step and of the JAX package's; every updated leaf
  by ``tests/_torch_lm_train.py``'s rule (0.05 x lr where the JAX
  clipped gradient is at least 1e-6, 2 x lr below it).  The compression
  rounds each summed gradient (``parallel.constrain.reduce_partial``):
  rounding each rank's partial sum instead moved leaves by a whole lr
  where those parts cancel.  Each micro-batch's tokens and labels reach
  ``loss_fn`` ``Shard(0)`` over 'data'.
* The dry run: rank 0's ``StepRecorder`` over a real prefill (olmo_1b,
  mamba2_130m) and a real train step (olmo_1b) counts the collectives
  (count and ring bytes by kind) and ``dot_flops`` that
  ``launch.dryrun.dry_run`` counts on a fake (2, 4) CPU group for the
  same cell: equal, not within a tolerance."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import _torch_spmd as H  # noqa: E402
from repro import configs as R_C  # noqa: E402
from repro import optim as R_optim  # noqa: E402
from repro.models import steps as R_S  # noqa: E402
from repro.models import transformer as R_T  # noqa: E402
from repro_torch import configs as T_C  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    fake_process_group,
    make_debug_mesh,
    spawn_world,
)
from repro_torch.parallel.sharding import ShardScheme  # noqa: E402

REL = 1e-5
LR = 3e-4                    # launch.dryrun.train_optimizer's AdamW
W_ATOL, GRAD_FLOOR = 0.05, 1e-6
TIMEOUT_S = 300.0
Z1 = {"tp": True, "fsdp": "zero1"}
MESH = (2, 4)
# name: (arch, accum_steps, smoke-config overrides[, scheme knobs]);
# qwen2's 14 heads at full width do not divide a 4-wide 'model' axis: 6
# over 4 here, whose merged attention output's gradient came back split
# over 'model'
TRAINS = {"olmo_1b-accum1": ("olmo_1b", 1, {}),
          "olmo_1b-accum4": ("olmo_1b", 4, {}),
          "olmo_1b-kvpar-accum1": ("olmo_1b", 1, {},
                                   {"attn_kv_parallel": True}),
          "qwen2_0_5b-6heads-accum1": (
              "qwen2_0_5b", 1, {"n_heads": 6, "n_kv_heads": 2,
                                "d_model": 96})}
# name: (arch, kind)
RECORDS = {"olmo_1b-prefill": ("olmo_1b", "prefill"),
           "mamba2_130m-prefill": ("mamba2_130m", "prefill"),
           "olmo_1b-train": ("olmo_1b", "train")}


def _cases() -> list:
    cases = [{"name": f"train-{name}", "run": "train", "arch": arch,
               "cfg_overrides": over, "mesh": MESH,
               "scheme": {**Z1, "accum_steps": n, **dict(*knobs)},
               "seed": 3}
              for name, (arch, n, over, *knobs) in TRAINS.items()]
    cases += [{"name": f"record-{name}", "run": "record", "arch": arch,
               "kind": kind, "mesh": MESH, "scheme": Z1, "seed": 4,
               "batch": H.BATCH, "seq": H.SEQ}
              for name, (arch, kind) in RECORDS.items()]
    return cases


def _r_cfg(arch, over=None):
    return dataclasses.replace(R_C.get_smoke(arch), **(over or {}))


@pytest.fixture(scope="module")
def jax_params():
    """The JAX package's params per arch, and per overridden config."""
    out = {a: R_T.init_params(_r_cfg(a), jax.random.PRNGKey(0))
           for a in {c["arch"] for c in _cases()}}
    out.update({f"train-{name}": R_T.init_params(_r_cfg(arch, over),
                                      jax.random.PRNGKey(0))
                for name, (arch, _, over, *_) in TRAINS.items() if over})
    return out


@pytest.fixture(scope="module")
def world(jax_params):
    np_params = {a: jax.tree.map(np.asarray, p)
                 for a, p in jax_params.items()}
    return spawn_world(H.WORLD, H.run_cases, _cases(), np_params,
                       timeout=TIMEOUT_S)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _jax_train(jax_params, name: str) -> dict:
    arch, accum, over = TRAINS[name][:3]
    cfg = _r_cfg(arch, over)
    p = jax_params[f"train-{name}" if over else arch]
    toks = jnp.asarray(H.tokens(cfg, H.BATCH, H.SEQ, 3))
    opt = R_optim.adamw(LR)
    step = jax.jit(R_S.make_train_step(cfg, opt, accum_steps=accum,
                                       grad_compression="bf16"))
    new_p, _, metrics = step(p, opt.init(p),
                             {"tokens": toks, "labels": toks})
    grads = jax.jit(jax.grad(lambda q: R_S.loss_fn(
        cfg, q, toks, toks)[0]))(p)
    return {"params": [np.asarray(x, np.float32)
                       for x in jax.tree.leaves(new_p)],
            "grads": [np.asarray(x, np.float32)
                      for x in jax.tree.leaves(grads)],
            "metrics": {k: float(v) for k, v in metrics.items()}}


@pytest.mark.parametrize("name", sorted(TRAINS))
def test_sharded_train_step_matches_local_and_jax(world, jax_params, name):
    got = world[0][f"train-{name}"]
    ref = _jax_train(jax_params, name)
    m, loc = got["metrics"], got["local_metrics"]
    for want in (loc, ref["metrics"]):
        assert abs(m["loss"] - want["loss"]) <= REL * abs(want["loss"])
        assert abs(m["ce"] - want["ce"]) <= REL * abs(want["ce"])
        assert (abs(m["grad_norm"] - want["grad_norm"])
                <= REL * abs(want["grad_norm"]))
    # the port's tree and the JAX package's list leaves in one order
    assert len(got["params"]) == len(ref["params"]) == len(ref["grads"])
    for new, loc_p, jax_p, g in zip(got["params"], got["local_params"],
                                    ref["params"], ref["grads"]):
        # the clipped gradient the JAX step applied (clip_norm 1)
        clipped = np.abs(g) * min(1.0, 1.0 / ref["metrics"]["grad_norm"])
        tol = np.where(clipped >= GRAD_FLOOR, W_ATOL * LR, 2 * LR)
        assert np.all(np.abs(new - jax_p) <= tol + 1e-7)
        assert np.all(np.abs(new - loc_p) <= tol + 1e-7)


@pytest.mark.parametrize("name", sorted(TRAINS))
def test_each_micro_batch_stays_batch_sharded(world, name):
    """``make_train_step`` pins each micro-batch slice (``pin_batch``):
    a slice of a batch-sharded DTensor comes back replicated otherwise,
    and the loss head then runs on every row on every rank."""
    want = ("(Shard(dim=0), Replicate())",) * 2
    for r in world:
        seen = r[f"train-{name}"]["placements"]
        assert seen == [want] * TRAINS[name][1]


def _dry_run(arch, kind) -> dict:
    cell = T_C.ShapeCell("spmd", kind, H.SEQ, H.BATCH)
    with fake_process_group(H.WORLD):
        mesh = make_debug_mesh(MESH, H.AXES, device_type="cpu")
        return D.dry_run(T_C.get_smoke(arch), cell, mesh, ShardScheme(**Z1),
                         device="cpu")


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_real_step_collectives_equal_the_dry_runs(world, name):
    got = world[0][f"record-{name}"]
    pred = _dry_run(*RECORDS[name])
    assert got["count_by_kind"] == pred["collectives"]["by_kind_count"]
    assert got["bytes_by_kind"] == pred["collectives"]["by_kind_bytes"]
    assert got["dot_flops"] == pred["per_device"]["hlo_flops"]
    assert sum(got["count_by_kind"].values()) > 0
