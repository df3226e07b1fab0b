"""Sharding plans: per-parameter PartitionSpecs from path-based rules
with divisibility guards, plus batch/cache/optimizer shardings — the
counterpart of ``repro.parallel.sharding``, the same names, fields and
rules.

Mesh-axis conventions (``launch/mesh.py``):
  single-pod: ('data', 'model')  = (16, 16)
  multi-pod : ('pod', 'data', 'model') = (2, 16, 16)

  'model' — tensor/expert parallelism (Megatron TP, MoE EP, KV heads)
  'data'  — data parallelism within a pod; optimizer-state sharding
            (ZeRO-1) and, for very large models, parameter sharding
            (ZeRO-3)
  'pod'   — pure data parallelism across pods

The rules are the JAX package's, learnt there under GSPMD: never shard
a weight's contracting dim over 'data'; never vocab-shard an embedding
table used by a gather (untied tables shard d_model, tied ones are
replicated); ZeRO-1 shards only the optimizer moments over
('model', 'data') composite dims.

What differs from the JAX package:

* A plan is made against a mesh's axis names and sizes only: a
  ``torch.distributed.device_mesh.DeviceMesh``, or an
  :class:`AbstractMesh` (names and sizes, no devices), so that a 16 x 16
  or 2 x 16 x 16 plan can be made on one card.
* :class:`PartitionSpec` is the port's own: a tuple whose entries are
  ``None``, an axis name or a tuple of names, equal entry for entry to
  JAX's ``PartitionSpec``.
* :class:`NamedSharding` pairs a mesh with a spec; its
  :meth:`~NamedSharding.placements` are the DTensor placements, one per
  mesh dim: ``Shard(d)`` where the spec puts that mesh axis on tensor
  dim ``d``, else ``Replicate()``.  A composite entry such as
  ``("model", "data")`` puts two mesh dims on one tensor dim.  DTensor
  splits such a dim in mesh-dim order (on the ('data', 'model') mesh:
  'data' major, 'model' minor), where JAX splits it in the entry's
  order ('model' major).  The shard sizes are the same and only which
  device holds which block differs; the ZeRO-1 / ZeRO-3 entries
  ``("model", "data")`` are the only ones whose order differs from the
  mesh's, and a size-1 mesh cannot tell the two apart.
* :func:`distribute` places a params-like tree as DTensors.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Optional

import numpy as np

from repro_torch.tree import tree_map, tree_map_with_path

if TYPE_CHECKING:   # models imports this package: no import at run time
    from repro_torch.models.config import ModelConfig

__all__ = [
    "AbstractMesh",
    "NamedSharding",
    "P",
    "PartitionSpec",
    "ShardScheme",
    "batch_axes",
    "default_scheme",
    "distribute",
    "make_batch_shardings",
    "make_cache_shardings",
    "make_opt_shardings",
    "make_param_shardings",
]


def _canonical_entry(entry):
    """JAX's canonical form of a spec entry: a list becomes a tuple, an
    empty tuple ``None``, a one-name tuple that name."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), an axis name, or
    a tuple of axis names (several mesh axes on one dim), kept in JAX's
    canonical form (``("data",)`` is ``"data"``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes without devices, for planning at a
    size the machine has not (``launch.mesh.abstract_mesh``)."""

    shape: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in length")


def mesh_axes(mesh) -> tuple:
    """The mesh's axis names: a DeviceMesh's ``mesh_dim_names`` or an
    abstract mesh's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh_axes(mesh), tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, the counterpart of ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: PartitionSpec

    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim in the mesh's order:
        ``Shard(d)`` for the tensor dim ``d`` whose entry names that mesh
        axis, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        dim_of = {}
        for d, entry in enumerate(self.spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    dim_of[a] = d
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                     for a in mesh_axes(self.mesh))


@dataclasses.dataclass(frozen=True)
class ShardScheme:
    tp: bool = True                  # tensor parallelism over 'model'
    fsdp: str = "zero1"              # 'none' | 'zero1' | 'zero3'
    expert_mode: str = "auto"        # 'ep' | 'tp' | 'none' | 'auto'
    batch_over_model: bool = False   # fold 'model' into the batch axes
    seq_over_model: bool = False     # shard activation seq dim (prefill)
    # TP on attention projections; False replicates them (the fix for
    # head counts indivisible by the model axis, e.g. qwen2.5's 40H/16)
    attn_tp: bool = True
    # gradient-accumulation microbatches (memory knob, not a sharding)
    accum_steps: int = 1
    # sequence parallelism: the residual stream between blocks sharded
    # over 'model' on the seq dim
    sp_residual: bool = False
    # context-parallel attention inner: KV parts over 'model' with a
    # log-sum-exp combine (modules.chunked_attention_kv_parallel)
    attn_kv_parallel: bool = False
    # weight-stationary decode: replicate the per-token activations
    # instead of batch-sharding them
    decode_replicate_batch: bool = False
    # out-projections (wo/wd/out_proj) sharded 2D on their CONTRACTING
    # dim: right for decode, wrong for training
    out_proj_contracting_2d: bool = False
    # TP-mode MoE: the ZeRO-3 data shard on the EXPERT dim instead of on
    # d/Fe
    moe_e_over_data: bool = False

    def resolve_expert_mode(self, cfg: ModelConfig, model_size: int) -> str:
        if self.expert_mode != "auto":
            return self.expert_mode
        if cfg.moe and cfg.moe.n_experts % model_size == 0:
            return "ep"
        return "tp"


def default_scheme(cfg: ModelConfig) -> ShardScheme:
    """Size-adaptive defaults:
      < 2B params : pure data parallelism
      2B - 20B    : Megatron TP + ZeRO-1
      > 20B       : TP + ZeRO-3
    """
    n = cfg.n_params()
    if n < 2e9:
        return ShardScheme(tp=False, fsdp="zero1", batch_over_model=True)
    if n > 2e10:
        return ShardScheme(tp=True, fsdp="zero3")
    return ShardScheme(tp=True, fsdp="zero1")


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def _guard(axis: Optional[str], dim: int, sizes: dict) -> Optional[str]:
    """Use `axis` for a dim only if the dim divides evenly."""
    if axis is None:
        return None
    return axis if _div(dim, sizes[axis]) else None


def batch_axes(mesh, scheme: ShardScheme, batch: int):
    """Axes used for the batch dimension of activations: the first
    candidate subset (preference-ordered, largest first) whose device
    product divides the batch; ('data', 'model') comes before
    ('pod', 'data')."""
    sizes = _axis_sizes(mesh)
    have = [a for a in ("pod", "data", "model") if a in sizes]
    if scheme.batch_over_model:
        prefs = [
            ("pod", "data", "model"), ("data", "model"), ("pod", "data"),
            ("data",), (),
        ]
    else:
        prefs = [("pod", "data"), ("data",), ()]
    for cand in prefs:
        axes = tuple(a for a in cand if a in have)
        if tuple(sorted(axes)) != tuple(sorted(set(axes))):
            continue
        total = int(np.prod([sizes[a] for a in axes])) if axes else 1
        if axes and batch % total == 0:
            return axes
        if not axes:
            return ()
    return ()


# ---------------------------------------------------------------------------
# Parameter shardings
# ---------------------------------------------------------------------------

_REPLICATED = {
    "ln1", "ln2", "final_norm", "gnorm",
    "conv_x_b", "conv_bc_b", "A_log", "D", "dt_bias", "router",
}
# (.., contracting_d, out) -> (None, out@model[,data if zero3])
_IN_PROJ = {"wq", "wk", "wv", "wg", "wu", "in_z", "in_x", "in_bc", "in_dt"}
# (.., in@model, out_d@data-if-zero3)
_OUT_PROJ = {"wo", "wd", "out_proj"}
_BIAS_TP = {"bq", "bk", "bv"}
_ATTN_NAMES = {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}


def _tp_dim(dim: int, sizes: dict, scheme: ShardScheme, *,
            force_zero3: bool = False):
    """Sharding for a weight's output/TP dim. fsdp ('data') is folded
    into the same dim — never a contracting dim — when zero3."""
    m = sizes.get("model", 1)
    d = sizes.get("data", 1)
    zero3 = force_zero3 or scheme.fsdp == "zero3"
    tp_ok = scheme.tp and dim % m == 0
    if tp_ok and zero3 and dim % (m * d) == 0:
        return ("model", "data")
    if tp_ok:
        return "model"
    if zero3 and dim % d == 0:
        return "data"
    return None


def _param_spec(path, shape, cfg, scheme, sizes, emode, *,
                force_zero3: bool = False) -> P:
    """`path`: the leaf's path parts (``repro_torch.tree``), e.g.
    ``("blocks", "moe", "wg")``."""
    name = str(path[-1])
    in_moe = "moe" in path
    tp = "model" if scheme.tp else None
    rank = len(shape)

    def lead(spec_tail: tuple) -> P:
        """Pad with None for the stacked-layer leading dims."""
        pad = rank - len(spec_tail)
        return P(*((None,) * pad + spec_tail))

    def tp_dim(dim):
        return _tp_dim(dim, sizes, scheme, force_zero3=force_zero3)

    if name in _REPLICATED and not in_moe:
        return P()
    if name == "router":
        return P()
    if name in _ATTN_NAMES and not scheme.attn_tp:
        # replicated attention: ZeRO-3 still shards over 'data' only
        if (force_zero3 or scheme.fsdp == "zero3") and len(shape) >= 2:
            d_ax = _guard("data", shape[-1], sizes)
            return lead((None, d_ax)) if len(shape) >= 2 else P()
        return P()
    if name == "embed":
        if cfg.tie_embeddings:
            return P()
        return P(None, tp_dim(shape[1]))
    if name == "lm_head":
        return P(None, tp_dim(shape[1]))
    zero3 = force_zero3 or scheme.fsdp == "zero3"
    data_out = "data" if zero3 else None

    def contracting(dim):
        """2D contracting-dim spec for decode-style out-projections."""
        return _tp_dim(dim, sizes, scheme, force_zero3=zero3)

    if in_moe and name in ("wg", "wu", "wd"):
        e, a, b = shape[-3], shape[-2], shape[-1]
        if emode == "ep":
            ex = _guard(tp, e, sizes)
            if name == "wd" and scheme.out_proj_contracting_2d:
                return lead((ex, _guard(data_out, a, sizes), None))
            return lead((ex, None, _guard(data_out, b, sizes)))
        if emode == "tp":
            e_ax = (
                "data" if (scheme.moe_e_over_data and zero3) else None
            )
            if name == "wd":   # (E, Fe, d)
                if scheme.out_proj_contracting_2d:
                    return lead((None, contracting(a), None))
                if e_ax:
                    return lead((e_ax, _guard(tp, a, sizes), None))
                return lead((None, _guard(tp, a, sizes),
                             _guard(data_out, b, sizes)))
            if e_ax:           # wg/wu (E@data, d, Fe@model)
                return lead((e_ax, None, _guard(tp, b, sizes)))
            return lead((None, None, tp_dim(b)))
        return lead((None, None, _guard(data_out, b, sizes)))
    if name in _IN_PROJ:
        return lead((None, tp_dim(shape[-1])))
    if name in _OUT_PROJ:
        if scheme.out_proj_contracting_2d:
            return lead((contracting(shape[-2]), None))
        return lead((_guard(tp, shape[-2], sizes),
                     _guard(data_out, shape[-1], sizes)))
    if name in _BIAS_TP:
        return lead((_guard(tp, shape[-1], sizes),))
    if name in ("conv_x_w", "conv_bc_w"):   # (L, K, C)
        return lead((None, _guard(tp, shape[-1], sizes)))
    return P()


def make_param_shardings(
    cfg: ModelConfig, mesh, params_tree: Any,
    scheme: Optional[ShardScheme] = None, *, force_zero3: bool = False,
) -> Any:
    """params_tree: a tree of tensors (``meta`` ones from
    ``transformer.param_specs`` allocate nothing).  force_zero3 is used
    for optimizer-moment trees (ZeRO-1)."""
    scheme = scheme or default_scheme(cfg)
    sizes = _axis_sizes(mesh)
    emode = scheme.resolve_expert_mode(cfg, sizes["model"])

    def one(path, leaf):
        spec = _param_spec(
            path, tuple(leaf.shape), cfg, scheme, sizes, emode,
            force_zero3=force_zero3,
        )
        return NamedSharding(mesh, spec)

    return tree_map_with_path(one, params_tree)


def make_opt_shardings(
    cfg: ModelConfig, mesh, params_tree: Any,
    scheme: Optional[ShardScheme] = None, kind: str = "adamw",
) -> Any:
    """ZeRO-1: optimizer moments shard over ('model','data') composite
    dims even when params are only TP-sharded. Scalars replicated."""
    from repro_torch.optim.optimizers import OptState

    moment_sh = make_param_shardings(
        cfg, mesh, params_tree, scheme, force_zero3=True
    )
    scalar = NamedSharding(mesh, P())
    if kind == "adamw":
        inner = {"m": moment_sh, "v": moment_sh}
    elif kind in ("sgd", "lion"):
        inner = moment_sh
    else:
        raise ValueError(kind)
    return OptState(step=scalar, inner=inner)


# ---------------------------------------------------------------------------
# Activation / batch / cache shardings
# ---------------------------------------------------------------------------


def make_batch_shardings(
    cfg: ModelConfig, mesh, specs: dict,
    scheme: Optional[ShardScheme] = None,
) -> dict:
    """Shardings for train/prefill input dicts (tokens/labels/
    frontend_embeds; ``configs.input_specs``): batch dim over the data
    axes, seq replicated (or over 'model' when scheme.seq_over_model)."""
    scheme = scheme or default_scheme(cfg)
    out = {}
    for k, v in specs.items():
        if k == "cache":
            out[k] = make_cache_shardings(cfg, mesh, v, scheme)
            continue
        if k == "token" and scheme.decode_replicate_batch:
            out[k] = NamedSharding(mesh, P())
            continue
        b = v.shape[0]
        baxes = batch_axes(mesh, scheme, b)
        spec = [baxes if baxes else None] + [None] * (len(v.shape) - 1)
        if scheme.seq_over_model and len(v.shape) >= 2:
            sizes = _axis_sizes(mesh)
            if _div(v.shape[1], sizes["model"]):
                spec[1] = "model"
        out[k] = NamedSharding(mesh, P(*spec))
    return out


def make_cache_shardings(
    cfg: ModelConfig, mesh, cache_tree: dict,
    scheme: Optional[ShardScheme] = None, *, allow_hd: bool = True,
) -> dict:
    """Decode-cache shardings.

    k/v (L, B, S, Hkv, hd): batch over data; heads over 'model' when
    divisible, else head_dim over 'model' (decode only — pass
    allow_hd=False for prefill outputs).
    ssd (L, B, H, P, N): batch over data; H over model else P.
    conv_* (L, B, K, C): batch over data; C over model when divisible.
    """
    scheme = scheme or default_scheme(cfg)
    sizes = _axis_sizes(mesh)
    # caches always use 'model', even when weights are not TP-sharded
    tp = "model"
    out = {}
    for kname, leaf in cache_tree.items():
        if kname == "len":
            out[kname] = NamedSharding(mesh, P())
            continue
        sh = leaf.shape
        b_ax = batch_axes(mesh, dataclasses.replace(
            scheme, batch_over_model=False), sh[1])
        if kname in ("k", "v"):
            h_ax = _guard(tp, sh[3], sizes)
            d_ax = (
                _guard(tp, sh[4], sizes)
                if (h_ax is None and allow_hd) else None
            )
            s_ax = None
            if not b_ax:
                # unbatchable (B=1, long-context): shard the sequence
                # dim over the idle data axes (sequence-parallel KV)
                cand = tuple(a for a in ("pod", "data") if a in sizes)
                tot = int(np.prod([sizes[a] for a in cand])) if cand else 0
                if cand and sh[2] % tot == 0:
                    s_ax = cand
            elif h_ax is None and d_ax is None:
                # kv-heads indivisible and hd-sharding disallowed:
                # sequence-shard the cache over 'model'
                s_ax = _guard("model", sh[2], sizes)
            spec = P(None, b_ax if b_ax else None, s_ax, h_ax, d_ax)
        elif kname == "ssd":
            h_ax = _guard(tp, sh[2], sizes)
            p_ax = _guard(tp, sh[3], sizes) if h_ax is None else None
            spec = P(None, b_ax if b_ax else None, h_ax, p_ax, None)
        elif kname in ("conv_x", "conv_bc"):
            spec = P(None, b_ax if b_ax else None, None,
                     _guard(tp, sh[3], sizes))
        else:
            spec = P()
        out[kname] = NamedSharding(mesh, spec)
    return out


def distribute(tree: Any, shardings: Any) -> Any:
    """Each tensor of `tree` as a DTensor placed by its sharding in
    `shardings` (a tree of the same structure whose meshes are
    DeviceMeshes): ``torch.distributed.tensor.distribute_tensor``.  A
    DTensor leaf is placed from its ``full_tensor()``."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(leaf, sh: NamedSharding):
        src = leaf.full_tensor() if isinstance(leaf, DTensor) else leaf
        return distribute_tensor(src.detach(), sh.mesh, sh.placements())

    return tree_map(one, tree, shardings)
