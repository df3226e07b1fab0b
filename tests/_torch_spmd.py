"""Rank bodies of ``tests/test_torch_spmd_*.py``: what each of the 8
``gloo`` ranks of a ``launch.mesh.spawn_world`` runs on the CPU.  A
child process imports this module by name, so it imports torch and the
port only, never ``jax`` or ``repro``: the parent passes the JAX
package's parameters in as NumPy trees (``jax.tree.map(np.asarray,
params)``) and compares what rank 0 returns with the JAX package
itself.

:func:`run_cases` runs a list of cases in one world, in order, and
returns ``{name: result}``: rank 0's results hold whole arrays (the
sharded output and the port's local one), the other ranks' only what
each rank sees of its own (its placements, its launch counts).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import configs as T_C
from repro_torch.launch import spmd
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.trace_analysis import StepRecorder
from repro_torch.models import steps as T_S
from repro_torch.models import transformer as T_T
from repro_torch.parallel.sharding import ShardScheme
from repro_torch.runtime import remesh_state
from repro_torch.tree import leaves

WORLD = 8
AXES = ("data", "model")
BATCH, SEQ = 8, 16


def tokens(cfg, batch: int, seq: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, seq), dtype=np.int32)


def _np(x):
    return x.detach().float().numpy()


def _mesh(shape):
    return make_debug_mesh(tuple(shape), AXES, device_type="cpu")


def _forward(rank, cfg, params, case):
    mesh = _mesh(case["mesh"])
    toks = torch.from_numpy(tokens(cfg, BATCH, SEQ, case["seed"]))
    logits, _ = spmd.forward(cfg, mesh, ShardScheme(**case["scheme"]),
                             params, toks)
    if rank:
        return None
    local, _, _ = T_T.forward(cfg, params, toks)
    return {"sharded": _np(logits), "local": _np(local)}


def _remesh(rank, cfg, params, case):
    """``remesh_state`` from a (2, 4) mesh over the 8 ranks onto a
    (1, 4) mesh over ranks 0-3, then a forward there.  Every rank takes
    part in the gather on the old mesh; ranks 4-7 hold empty local
    tensors afterwards and run nothing on the new mesh."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    scheme = ShardScheme(**case["scheme"])
    state_a = remesh_state(cfg, params, _mesh((2, 4)), scheme)
    mesh_b = DeviceMesh("cpu", torch.arange(4).reshape(1, 4),
                        mesh_dim_names=AXES)
    state_b = remesh_state(cfg, state_a, mesh_b, scheme)
    local_numel = sum(t.to_local().numel() for t in leaves(state_b))
    seen = {"in_new_mesh": mesh_b.get_coordinate() is not None,
            "all_dtensors": all(isinstance(t, DTensor)
                                for t in leaves(state_b)),
            "local_numel": local_numel}
    if not seen["in_new_mesh"]:
        return seen
    toks = torch.from_numpy(tokens(cfg, 4, 8, case["seed"]))
    logits, _ = spmd.forward(cfg, mesh_b, scheme, state_b, toks)
    if rank == 0:
        local, _, _ = T_T.forward(cfg, params, toks)
        seen.update(sharded=_np(logits), local=_np(local))
    return seen


def _decode(rank, cfg, params, case):
    """A sharded prefill of the first ``n_prompt`` tokens, then one
    sharded serve step per further token (teacher-forced), each on the
    cache the step before returned, placed anew by
    ``make_cache_shardings``."""
    mesh = _mesh(case["mesh"])
    scheme = ShardScheme(**case["scheme"])
    toks = torch.from_numpy(tokens(cfg, BATCH, case["n_prompt"]
                                   + case["n_decode"], case["seed"]))
    n = case["n_prompt"]
    max_len = n + case["n_decode"] + 2
    got, want = [], []
    last, cache = spmd.run_step(cfg, "prefill", mesh, scheme, params,
                                {"tokens": toks[:, :n]})
    full = T_S.decode_cache(cfg, cache, max_len, device="cpu")
    got.append(_np(last))
    for i in range(n, n + case["n_decode"]):
        logits, new = spmd.run_step(cfg, "decode", mesh, scheme, params,
                                    {"token": toks[:, i:i + 1],
                                     "cache": full})
        full = {**new, "len": i + 1}
        got.append(_np(logits))
    if rank:
        return None
    ref_last, ref_cache = spmd.local_step(cfg, "prefill", params,
                                          {"tokens": toks[:, :n]})
    ref_full = T_S.decode_cache(cfg, ref_cache, max_len, device="cpu")
    want.append(_np(ref_last))
    for i in range(n, n + case["n_decode"]):
        ref_logits, _ = spmd.local_step(cfg, "decode", params,
                                        {"token": toks[:, i:i + 1],
                                         "cache": ref_full})
        ref_full["len"] = i + 1
        want.append(_np(ref_logits))
    return {"sharded": got, "local": want}


def _train(rank, cfg, params, case):
    """One AdamW train step (``launch.dryrun.step_fn``'s: bf16 gradient
    compression, ``accum_steps``), with the placements of the tokens and
    labels each micro-step's ``loss_fn`` sees on this rank."""
    mesh = _mesh(case["mesh"])
    scheme = ShardScheme(**case["scheme"])
    toks = torch.from_numpy(tokens(cfg, BATCH, SEQ, case["seed"]))
    batch = {"tokens": toks, "labels": toks}
    seen = []
    loss_fn = T_S.loss_fn

    def spy(cfg_, params_, tokens_, labels_, *args, **kwargs):
        seen.append((repr(tuple(tokens_.placements)),
                     repr(tuple(labels_.placements))))
        return loss_fn(cfg_, params_, tokens_, labels_, *args, **kwargs)

    T_S.loss_fn = spy
    try:
        new_p, _, metrics = spmd.run_step(cfg, "train", mesh, scheme, params,
                                          batch)
    finally:
        T_S.loss_fn = loss_fn
    out = {"placements": seen}
    if rank:
        return out
    ref_p, _, ref_m = spmd.local_step(cfg, "train", params, batch, scheme)
    out.update(
        metrics={k: float(v) for k, v in metrics.items()},
        local_metrics={k: float(v) for k, v in ref_m.items()},
        params=[_np(t) for t in leaves(new_p)],
        local_params=[_np(t) for t in leaves(ref_p)])
    return out


def _record(rank, cfg, params, case):
    """The step of ``case["kind"]`` with rank 0's per-device program
    read by a ``StepRecorder`` (the dry run's own counter)."""
    mesh = _mesh(case["mesh"])
    scheme = ShardScheme(**case["scheme"])
    toks = torch.from_numpy(tokens(cfg, case["batch"], case["seq"],
                                   case["seed"]))
    batch = {"tokens": toks}
    if case["kind"] == "train":
        batch["labels"] = toks
    rec = StepRecorder() if rank == 0 else None
    spmd.run_step(cfg, case["kind"], mesh, scheme, params, batch,
                  recorder=rec)
    if rank:
        return None
    coll = rec.collectives
    return {"bytes_by_kind": coll.bytes_by_kind,
            "count_by_kind": coll.count_by_kind,
            "dot_flops": rec.dot_flops}


_RUNNERS = {"forward": _forward, "remesh": _remesh, "decode": _decode,
            "train": _train, "record": _record}


def run_cases(rank: int, cases: list, np_params: dict) -> dict:
    """Each case (a dict with ``name``, ``run`` — a key of the runners —
    ``arch`` and the runner's own keys) on the smoke config of its arch,
    from the NumPy params ``np_params[arch]`` (the JAX package's
    ``init_params(PRNGKey(0))``).  ``cfg_overrides`` replaces fields of
    the smoke config; such a case's params are ``np_params[name]``."""
    out = {}
    for case in cases:
        over = case.get("cfg_overrides", {})
        cfg = dataclasses.replace(T_C.get_smoke(case["arch"]), **over)
        params = T_T.params_from_jax(
            cfg, np_params[case["name"] if over else case["arch"]],
            device="cpu")
        out[case["name"]] = _RUNNERS[case["run"]](rank, cfg, params, case)
    return out


def _routed_keys() -> list:
    """The device keys ("CPU", "CUDA") with a python implementation of
    the functional all-gather ("_c10d_functional/all_gather_into_tensor/
    <key>" entries of ``torch.library``'s registry; torch registers its
    own for other keys)."""
    keys = (k.rsplit("/", 1)[1] for k in torch.library._impls
            if k.startswith("_c10d_functional/all_gather_into_tensor/"))
    return sorted(k for k in keys if k in ("CPU", "CUDA"))


def all_gather_shim(rank: int) -> dict:
    """gloo's own all-gather of this rank's (3, 2, 2) and (1, 5) tensors
    (values that name the rank), then the same gathers through
    ``all_gather_through_all_to_all`` registered for the CPU key, with
    the keys registered before, during and after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import all_gather_through_all_to_all

    xs = [torch.arange(12.0).reshape(3, 2, 2) + 100 * rank,
          torch.arange(5, dtype=torch.int64).reshape(1, 5) * (rank + 1)]
    ops = torch.ops._c10d_functional
    group = dist.group.WORLD

    def gather():
        # the op DTensor and full_tensor() issue
        # NumPy: a tensor would cross back to the parent by a file
        # descriptor, gone once this rank exits
        return [ops.wait_tensor(ops.all_gather_into_tensor(
            x, group.size(), group.group_name)).numpy() for x in xs]

    native = gather()
    before = _routed_keys()
    lib = all_gather_through_all_to_all(dispatch_key="CPU")
    during = _routed_keys()
    routed = gather()
    del lib
    return {"native": native, "routed": routed, "before": before,
            "during": during, "after": _routed_keys()}


def routed_keys(rank: int) -> list:
    """What ``spawn_world`` registered in this rank."""
    del rank
    return _routed_keys()


def ok(rank: int, value):
    """``spawn_world``'s own tests: every rank's answer."""
    import torch.distributed as dist

    t = torch.tensor([float(rank)])
    dist.all_reduce(t)
    return {"rank": rank, "world": dist.get_world_size(),
            "sum": float(t), "value": value}


def fail_on(rank: int, bad: int):
    """Rank `bad` raises; the others block in a collective it never
    joins."""
    import torch.distributed as dist

    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()
    return rank


def hang_on(rank: int, bad: int):
    """Rank `bad` never returns; the others return."""
    import time

    if rank == bad:
        time.sleep(3600)
    return rank
