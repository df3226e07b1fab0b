"""Dry run: trace every (architecture x input shape) cell's step on the
production mesh and record per-device memory, collective and roofline
numbers — the counterpart of ``repro.launch.dryrun``.

The JAX package lowers and compiles each cell on a 512-device fake XLA
host and reads ``memory_analysis()`` and the partitioned HLO.  Here the
mesh is a real ``DeviceMesh`` of 256 (or 512) ranks over a fake process
group (``launch.mesh.fake_process_group``), the parameters, optimizer
state, batch and cache are fake DTensors placed by
``parallel.sharding``'s plans (nothing is allocated), and one eager
trace of the port's own step under ``trace_analysis.StepRecorder``
gives the per-device program: its collectives, matmul FLOPs, HBM
traffic and peak live bytes.  No XLA, no environment variable.

With ``device="cuda"`` (the default) the fake tensors are CUDA tensors,
so the trace takes the card's own path: kernel 3 is one op per layer
(its fake implementation), and nothing is launched.  ``device="cpu"``
traces the CPU path (the tests' mode).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu --out results/dryrun_torch

What differs from the JAX package: the collectives are those DTensor
emits for the port's eager step (not GSPMD's); every Python loop is
unrolled by the trace, so no trip counts are read (and there is no
``whiles`` entry); ``trace_s`` takes the place of ``lower_s`` and
``compile_s``; the roofline is priced with the H100's datasheet
constants unless others are passed.  ``per_device`` keeps the
reference's key names (``hlo_flops``, ``hlo_bytes``) for the traced
program's counts, so either package's ``roofline_terms`` reads either
result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch import configs as C
from repro_torch.launch.mesh import (
    PRODUCTION_SHAPES,
    fake_process_group,
    make_production_mesh,
)
from repro_torch.launch.trace_analysis import (
    StepRecorder,
    hide_sharding_propagation,
)
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import ShardScheme, default_scheme

__all__ = [
    "HBM_BW",
    "LINK_BW",
    "PEAK_BF16",
    "build_step",
    "dry_run",
    "fake_placement",
    "main",
    "roofline_terms",
    "run_cell",
    "step_fn",
    "train_optimizer",
]

# H100 SXM datasheet, per GPU: dense bf16 tensor-core rate, HBM3 rate,
# and one direction of NVLink 4 (18 links x 25 GB/s) in place of the
# JAX package's ICI_BW
PEAK_BF16 = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9


def _fake_dtensor(shape, dtype, sharding, device):
    """A fake DTensor of global `shape` placed by `sharding` (a
    ``NamedSharding`` on a DeviceMesh): its local shard is an
    uninitialised tensor of the mode's fake kind."""
    from torch.distributed.tensor import DTensor, Shard

    placements = sharding.placements()
    shape = torch.Size(shape)
    # rank 0's shard: each mesh dim that shards a tensor dim cuts it in
    # mesh-dim order, the first piece the larger one (torch.chunk's)
    local_shape = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = sharding.mesh.size(i)
            local_shape[p.dim] = -(-local_shape[p.dim] // n)
    local = torch.empty(local_shape, dtype=dtype, device=device)
    return DTensor.from_local(local, sharding.mesh, placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _place(tree, shardings, device, dtype=None):
    """Fake DTensors for a tree of ``meta`` tensors (the port's shape
    specs) by the tree of shardings of the same structure."""
    from repro_torch.tree import tree_map

    return tree_map(
        lambda spec, sh: _fake_dtensor(spec.shape, dtype or spec.dtype, sh,
                                       device),
        tree, shardings)


def fake_placement(device):
    """The dry run's placement for :func:`build_step`: every argument a
    fake DTensor of its spec's shape on `device`, nothing allocated."""
    def place(what, specs, shardings):
        del what
        return _place(specs, shardings, device)

    return place


def _pin(tree, shardings):
    """Redistribute each DTensor of `tree` to its sharding (the
    reference's ``out_shardings``)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_map

    def one(x, sh):
        if isinstance(x, DTensor):
            return x.redistribute(sh.mesh, sh.placements())
        return x

    return tree_map(one, tree, shardings)


def train_optimizer(cfg: ModelConfig):
    """The AdamW a traced train step updates with (bf16 moments past
    1e11 parameters)."""
    from repro_torch.optim import adamw

    return adamw(3e-4, state_dtype=torch.bfloat16
                 if cfg.n_params() > 1e11 else torch.float32)


def step_fn(cfg: ModelConfig, kind: str, scheme: ShardScheme):
    """The step a cell of `kind` runs: the train step (AdamW of
    :func:`train_optimizer`, bf16 gradient compression,
    ``scheme.accum_steps``), the prefill step or the serve step."""
    from repro_torch.models.steps import (
        make_prefill_step,
        make_serve_step,
        make_train_step,
    )

    if kind == "train":
        return make_train_step(cfg, train_optimizer(cfg),
                               grad_compression="bf16",
                               accum_steps=scheme.accum_steps)
    if kind == "prefill":
        return make_prefill_step(cfg)
    return make_serve_step(cfg)


def build_step(cfg: ModelConfig, shape, mesh, scheme: ShardScheme | None
               = None, *, device="cuda", place=None, cache_len=None):
    """The cell's step as a closure over DTensor arguments: ``(run,
    args)``, ``run()`` running one train / prefill / decode step
    (:func:`step_fn`) and pinning what it returns as the reference's
    ``out_shardings`` do, ``args`` the tree of its arguments.  `shape` is
    a name of ``configs.SHAPES`` or a ``configs.ShapeCell``.

    ``place(what, specs, shardings)`` places each argument (`what` is
    ``"params"``, ``"opt"``, ``"batch"``, ``"cache"`` or ``"token"``,
    `specs` its ``meta`` shape specs): by default
    :func:`fake_placement` on `device`, the dry run's, to be called
    inside a ``FakeTensorMode``; ``launch.spmd`` places real tensors
    through the same plans, so the real step and the traced one are one
    program.  A decode's cache holds ``cache_len`` tokens (by default
    the cell's seq - 1).  The counterpart of the reference's
    ``build_lowered``."""
    from repro_torch.models.transformer import param_specs
    from repro_torch.parallel.sharding import (
        make_batch_shardings,
        make_cache_shardings,
        make_opt_shardings,
        make_param_shardings,
    )

    scheme = scheme or default_scheme(cfg)
    place = place or fake_placement(device)
    cell = shape if isinstance(shape, C.ShapeCell) else C.SHAPES[shape]
    specs = C.input_specs(cfg, cell)
    ps_tree = param_specs(cfg)
    p_sh = make_param_shardings(cfg, mesh, ps_tree, scheme)
    params = place("params", ps_tree, p_sh)
    b_sh = make_batch_shardings(cfg, mesh, specs, scheme)
    step = step_fn(cfg, cell.kind, scheme)

    if cell.kind == "train":
        o_sh = make_opt_shardings(cfg, mesh, ps_tree, scheme, "adamw")
        opt_state = place("opt", train_optimizer(cfg).init(ps_tree), o_sh)
        args = (params, opt_state, place("batch", specs, b_sh))

        def run():
            p, o, metrics = step(*args)
            return _pin(p, p_sh), _pin(o, o_sh), metrics

        return run, args

    if cell.kind == "prefill":
        batch = place("batch", specs, b_sh)
        args = (params, batch["tokens"], batch.get("frontend_embeds"))

        def run():
            logits, cache = step(*args)
            # pin the returned cache as the reference does: heads over
            # 'model' where they divide, batch over the data axes, never
            # head_dim
            c_sh = make_cache_shardings(cfg, mesh, cache, scheme,
                                        allow_hd=False)
            return logits, _pin(cache, c_sh)

        return run, args

    c_sh = {k: v for k, v in b_sh["cache"].items() if k != "len"}
    cache = place("cache", {k: specs["cache"][k] for k in c_sh}, c_sh)
    # the new token lands in the last slot of the seq-long cache
    cache["len"] = cell.seq - 1 if cache_len is None else cache_len
    token = place("token", specs["token"], b_sh["token"])
    args = (params, cache, token)

    def run():
        logits, new_cache = step(*args)
        return logits, _pin({k: v for k, v in new_cache.items()
                             if k != "len"}, c_sh)

    return run, args


def _storage_keys(tree) -> dict:
    from repro_torch.launch.trace_analysis import _local, _tensors

    out = {}
    for t in _tensors(tree):
        st = _local(t).untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def dry_run(cfg: ModelConfig, shape, mesh, scheme: ShardScheme | None =
            None, *, device="cuda") -> dict:
    """Trace one step of `cfg` at `shape` on `mesh` under `scheme` and
    return the result dict's measured part: ``devices``, ``trace_s``,
    ``memory``, ``collectives`` and ``per_device``.  Nothing is
    allocated and nothing is launched."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.parallel.constrain import on_mesh

    scheme = scheme or default_scheme(cfg)
    device = torch.device(device)
    rec = StepRecorder()
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True), on_mesh(mesh, scheme):
        run, args = build_step(cfg, shape, mesh, scheme, device=device)
        arg_bytes = rec.track(args)
        arg_keys = _storage_keys(args)
        with rec, hide_sharding_propagation(rec):
            out = run()
        out_keys = _storage_keys(out)
    trace_s = time.perf_counter() - t0
    out_bytes = sum(out_keys.values())
    alias_bytes = sum(n for k, n in out_keys.items() if k in arg_keys)
    peak = rec.peak_bytes
    coll = rec.collectives
    return {
        "devices": mesh.size(),
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            # what the step held beyond its arguments and results
            "temp_bytes": peak - arg_bytes - out_bytes + alias_bytes,
            "alias_bytes": alias_bytes,
            "peak_bytes_per_device": peak,
        },
        "collectives": {
            "per_device_bytes": coll.total_bytes,
            "by_kind_bytes": coll.bytes_by_kind,
            "by_kind_count": coll.count_by_kind,
        },
        "per_device": {
            "hlo_flops": rec.dot_flops,    # traced matmul flops
            "hlo_bytes": rec.hbm_bytes,    # traced HBM traffic
        },
    }


@contextlib.contextmanager
def _world(n: int):
    """The caller's process group when it holds `n` ranks, else a fake
    one of `n` ranks for the block."""
    import torch.distributed as dist

    if dist.is_initialized():
        yield
        return
    with fake_process_group(n):
        yield


def run_cell(
    arch: str, shape: str, *, multi_pod: bool,
    scheme: ShardScheme | None = None, extrapolate: bool = True,
    device="cuda",
) -> dict:
    """One cell on the production mesh (16 x 16, or 2 x 16 x 16 with
    `multi_pod`), in the reference's result layout.  A cell the arch
    cannot run is skipped before any mesh is built.  `extrapolate` is
    accepted for the reference's signature; a trace needs none."""
    del extrapolate
    cfg = C.get(arch)
    if not C.cell_supported(cfg, shape):
        return {
            "arch": arch, "shape": shape, "multi_pod": multi_pod,
            "status": "skipped",
            "reason": "long_500k needs sub-quadratic attention "
                      "(full-attention arch; see docs/ARCHITECTURE.md §7)",
        }
    n = 1
    for s in PRODUCTION_SHAPES[multi_pod]:
        n *= s
    dev = torch.device(device)
    with _world(n):
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=dev.type)
        res = dry_run(cfg, shape, mesh, scheme, device=dev)
    return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
            "devices": res.pop("devices"), "status": "ok", **res}


def roofline_terms(result: dict, cfg: ModelConfig, shape: str, *,
                   peak_flops: float = PEAK_BF16, hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> dict:
    """The three roofline terms, in seconds per step, priced with the
    given chip constants (the H100 SXM's by default; one link rate for
    every collective, as the reference prices ICI)."""
    pd = result.get("per_device", {})
    flops = pd.get("hlo_flops", 0.0)
    bytes_ = pd.get("hlo_bytes", 0.0)
    coll = result["collectives"]["per_device_bytes"]
    compute_s = flops / peak_flops
    memory_s = bytes_ / hbm_bw
    collective_s = coll / link_bw
    dominant = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda kv: kv[1],
    )[0]
    sh = C.SHAPES[shape]
    n_tok = sh.batch * (sh.seq if sh.kind == "train" else
                        (sh.seq if sh.kind == "prefill" else 1))
    mult = 3 if sh.kind == "train" else 1  # fwd+bwd
    model_flops = 2 * mult * cfg.n_active_params() * n_tok
    denom = flops * result["devices"]
    return {
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
        "model_flops": model_flops,
        "useful_ratio": model_flops / denom if denom else 0.0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=("off", "on", "both"),
                    default="off")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--no-extrapolate", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda traces the card's "
                         "path, cpu the CPU path")
    args = ap.parse_args(argv)

    cells = []
    archs = C.ARCH_NAMES if (args.all or not args.arch) else (
        C.canonical(args.arch),)
    shapes = tuple(C.SHAPES) if (args.all or not args.shape) else (
        args.shape,)
    pods = {"off": (False,), "on": (True,), "both": (False, True)}[
        args.multi_pod]
    for mp in pods:
        for a in archs:
            for s in shapes:
                cells.append((a, s, mp))

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    summary = []
    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
        fp = outdir / f"{tag}.json"
        if fp.exists():
            r = json.loads(fp.read_text())
            print(f"[cached ] {tag}: {r['status']}")
            summary.append(r)
            continue
        print(f"[running] {tag} ...", flush=True)
        try:
            r = run_cell(arch, shape, multi_pod=mp,
                         extrapolate=not args.no_extrapolate,
                         device=args.device)
            if r["status"] == "ok":
                cfg = C.get(arch)
                r["roofline"] = roofline_terms(r, cfg, shape)
                print(
                    f"    ok: trace {r['trace_s']}s, "
                    f"peak {r['memory']['peak_bytes_per_device']/2**30:.2f} "
                    f"GiB/dev, coll {r['collectives']['per_device_bytes']/2**30:.2f} "
                    f"GiB/dev, dominant={r['roofline']['dominant']}",
                    flush=True,
                )
            else:
                print(f"    {r['status']}: {r.get('reason','')}", flush=True)
        except Exception as e:  # record failures — they are bugs
            r = {
                "arch": arch, "shape": shape, "multi_pod": mp,
                "status": "error", "error": repr(e),
                "traceback": traceback.format_exc()[-2000:],
            }
            print(f"    ERROR: {e!r}", flush=True)
        fp.write_text(json.dumps(r, indent=2, default=float))
        summary.append(r)

    ok = sum(1 for r in summary if r["status"] == "ok")
    sk = sum(1 for r in summary if r["status"] == "skipped")
    er = sum(1 for r in summary if r["status"] == "error")
    print(f"\n=== dry-run: {ok} ok, {sk} skipped(by-design), {er} errors ===")
    (outdir / "summary.json").write_text(
        json.dumps(summary, indent=2, default=float)
    )
    return 0 if er == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
