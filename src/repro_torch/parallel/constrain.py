"""Mesh-aware sharding constraints usable from model code — the
counterpart of ``repro.parallel.constrain``.

``constrain(x, *axes)`` resolves a spec against the ambient mesh when
one is active: entries naming axes the mesh has not are dropped (e.g.
'pod' on a single-pod mesh), and an entry whose axes do not divide its
dim evenly is dropped.  With no mesh (unit tests, the serving and
training paths) it is the identity.  The JAX package reads the mesh of
a ``with mesh:`` block; the port sets it with :func:`use_mesh`.

What the resolved spec does to a tensor: a DTensor is redistributed to
it; a plain tensor is returned unchanged.  Model code computes on local
tensors, and on a size-1 mesh the whole tensor is local, so there is
nothing to move.  :func:`resolved_spec` gives the spec itself, the one
the JAX package hands to ``with_sharding_constraint``.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.parallel.sharding import (
    NamedSharding,
    PartitionSpec as P,
    _axis_sizes,
    mesh_axes,
)

__all__ = [
    "attn_kv_parallel_enabled",
    "batch_local",
    "batch_over_model",
    "constrain",
    "constrain_kv",
    "constrain_ssd",
    "gather_data_axes",
    "merge_dims",
    "on_mesh",
    "pick_batch_axes",
    "pin_batch",
    "reduce_partial",
    "resolved_spec",
    "scheme_context",
    "sp_residual_enabled",
    "split_dim",
    "use_mesh",
]

# set by the launcher: lets model-internal pins follow the ShardScheme's
# policy without plumbing it through every call
_BATCH_OVER_MODEL = contextvars.ContextVar("batch_over_model",
                                           default=False)
_SP_RESIDUAL = contextvars.ContextVar("sp_residual", default=False)
_ATTN_KV_PARALLEL = contextvars.ContextVar("attn_kv_parallel",
                                           default=False)
_DECODE_REPLICATE = contextvars.ContextVar("decode_replicate_batch",
                                           default=False)
# the ambient mesh (a DeviceMesh or an AbstractMesh), or None
_MESH = contextvars.ContextVar("mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make `mesh` the ambient mesh of the block (the JAX package's
    ``with mesh:``)."""
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


@contextlib.contextmanager
def batch_over_model(enabled: bool):
    tok = _BATCH_OVER_MODEL.set(enabled)
    try:
        yield
    finally:
        _BATCH_OVER_MODEL.reset(tok)


@contextlib.contextmanager
def scheme_context(scheme):
    """Expose the ShardScheme's model-internal knobs to the model code
    run inside the block."""
    t1 = _BATCH_OVER_MODEL.set(getattr(scheme, "batch_over_model", False))
    t2 = _SP_RESIDUAL.set(getattr(scheme, "sp_residual", False))
    t3 = _ATTN_KV_PARALLEL.set(getattr(scheme, "attn_kv_parallel", False))
    t4 = _DECODE_REPLICATE.set(
        getattr(scheme, "decode_replicate_batch", False)
    )
    try:
        yield
    finally:
        _BATCH_OVER_MODEL.reset(t1)
        _SP_RESIDUAL.reset(t2)
        _ATTN_KV_PARALLEL.reset(t3)
        _DECODE_REPLICATE.reset(t4)


@contextlib.contextmanager
def on_mesh(mesh, scheme):
    """The context of a sharded step: `mesh` ambient (:func:`use_mesh`),
    `scheme`'s model-internal knobs (:func:`scheme_context`), and
    DTensor's ``implicit_replication``, so that a plain tensor the model
    makes (an ``arange``, a mask, a zero) meets a DTensor as a
    replicated one.  The counterpart of the reference's ``with mesh:``
    around a jitted sharded step."""
    from torch.distributed.tensor.experimental import implicit_replication

    with use_mesh(mesh), scheme_context(scheme), implicit_replication():
        yield mesh


def sp_residual_enabled() -> bool:
    return _SP_RESIDUAL.get()


def attn_kv_parallel_enabled() -> bool:
    return _ATTN_KV_PARALLEL.get()


def pick_batch_axes(dim: int, sizes: dict) -> tuple:
    """Largest preference-ordered axis subset whose product divides
    `dim` (mirrors sharding.batch_axes)."""
    if _DECODE_REPLICATE.get():
        return ()
    if _BATCH_OVER_MODEL.get():
        prefs = [("pod", "data", "model"), ("data", "model"),
                 ("pod", "data"), ("data",)]
    else:
        prefs = [("pod", "data"), ("data",)]
    for cand in prefs:
        axes = tuple(a for a in cand if a in sizes)
        total = 1
        for a in axes:
            total *= sizes[a]
        if axes and dim % total == 0:
            return axes
    return ()


def pin_batch(x, *rest):
    """Constrain dim 0 as a batch dim (policy-aware), dims 1.. by
    `rest` (padded with None)."""
    mesh = _ambient_mesh()
    if mesh is None:
        return x
    sizes = _axis_sizes(mesh)
    axes = pick_batch_axes(x.shape[0], sizes)
    spec = [axes if axes else None] + list(rest)
    spec += [None] * (x.ndim - len(spec))
    return constrain(x, *spec)


def _ambient_mesh():
    return _MESH.get()


def _filter(spec, names) -> list:
    def filt(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            return kept if kept else None
        return entry if entry in names else None

    return [filt(e) for e in spec]


def constrain(x, *spec):
    """spec entries: None, an axis name, or a tuple of axis names.
    Unknown axis names are dropped (e.g. 'pod' on a single-pod mesh)."""
    mesh = _ambient_mesh()
    if mesh is None:
        return x
    return _apply(x, _filter(spec, set(mesh_axes(mesh))), mesh)


def _guarded(shape, cleaned, sizes: dict):
    """The spec left after dropping each entry whose axes do not divide
    its dim, or None when no entry is left."""
    final = []
    for dim, entry in zip(shape, cleaned):
        if entry is None:
            final.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        total = 1
        for a in axes:
            total *= sizes[a]
        final.append(entry if dim % total == 0 else None)
    if all(e is None for e in final):
        return None
    return P(*final)


def _apply(x, cleaned, mesh):
    # guard divisibility per entry: drop only the offending entry
    spec = _guarded(x.shape, cleaned, _axis_sizes(mesh))
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(
            x.device_mesh, NamedSharding(x.device_mesh, spec).placements())
    return x


def resolved_spec(shape, *spec, mesh):
    """The spec :func:`constrain` resolves for a tensor of `shape` on
    `mesh` (unknown axes and indivisible entries dropped), or None where
    it leaves the tensor alone."""
    cleaned = _filter(spec, set(mesh_axes(mesh)))
    return _guarded(tuple(shape), cleaned, _axis_sizes(mesh))


def batch_local(fn, *tensors):
    """``fn(*tensors)`` computed from each rank's own rows: dim 0 of every
    tensor is the batch (MoE token groups: batch rows), and ``fn`` keeps
    rows apart.  On plain tensors it is ``fn(*tensors)``.  When one of
    them is a DTensor, each DTensor is redistributed to the batch
    sharding of the first (its ``Shard(0)`` mesh dims, the others
    replicated), ``fn`` runs on the local shards, and what it returns
    (a tensor, or a tuple of them) comes back as DTensors of that
    sharding: the MoE dispatch's scatter and gather, which DTensor does
    not take whole, run per shard as GSPMD partitions them."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    first = next((t for t in tensors if isinstance(t, DTensor)), None)
    if first is None:
        return fn(*tensors)
    mesh = first.device_mesh
    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in first.placements)
    out = fn(*(t.redistribute(mesh, rows).to_local()
               if isinstance(t, DTensor) else t for t in tensors))

    def wrap(o):
        return DTensor.from_local(o, mesh, rows, run_check=False)

    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def split_dim(x, dim: int, parts: int, size: int):
    """``x`` with dim `dim` split into (`parts`, `size`), as ``reshape``
    does.  A DTensor sharded on that dim over mesh dims whose shard count
    does not divide `parts` (qwen2.5's 40 heads over a 16-wide 'model')
    is first replicated on it, which DTensor's ``view`` demands and
    GSPMD does by itself; on a plain tensor this is the reshape."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dim = dim % x.ndim
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        on_dim = [i for i, p in enumerate(x.placements)
                  if isinstance(p, Shard) and p.dim == dim]
        n = 1
        for i in on_dim:
            n *= mesh.size(i)
        if parts % n:
            x = x.redistribute(mesh, tuple(
                Replicate() if i in on_dim else p
                for i, p in enumerate(x.placements)))
    return x.reshape(*x.shape[:dim], parts, size, *x.shape[dim + 1:])


def gather_data_axes(w):
    """A weight as its product uses it under ZeRO-3: a DTensor whose
    dims the data axes ('pod', 'data') shard is all-gathered over them,
    'model' kept, as GSPMD gathers an FSDP-sharded weight before its
    dot.  DTensor would instead keep the weight's ('model', 'data')
    split on the product's output dim and gather the batch, and a dim
    split over two mesh dims then fails the head reshapes of the SSD
    (``_StridedShard`` cannot be unflattened).  Plain tensors, and
    DTensors no data axis shards, are returned as they are."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names or ()
    keep = tuple(Replicate() if names[i] in ("pod", "data") else p
                 for i, p in enumerate(w.placements))
    if keep == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, keep)


def reduce_partial(x):
    """A DTensor whose value is a pending sum over some mesh dims
    (``Partial`` placements) as that sum, replicated over them (an
    all-reduce); plain tensors, and DTensors with nothing pending, as
    they are.  GSPMD reduces a product's partial sums before any other
    op reads them; DTensor lets a dtype cast through, which rounds each
    rank's partial sum instead of the sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(x, DTensor) or not any(
            isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if isinstance(p, Partial) else p for p in x.placements))


class _GradAsInput(torch.autograd.Function):
    """The identity, whose backward brings the gradient to the input's
    own placements (a DTensor).  The gradient of a pending sum
    (``Partial``) is each part's: replicated over those mesh dims."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Partial, Replicate

        ctx.mesh = x.device_mesh
        ctx.placements = tuple(Replicate() if isinstance(p, Partial) else p
                               for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.placements)


def merge_dims(x, dim: int):
    """``x`` with dims `dim` and `dim` + 1 merged into one, as
    ``reshape`` does (the counterpart of :func:`split_dim`).  On a
    DTensor the gradient of the merged tensor is first brought back to
    ``x``'s own placements: a product that shards its contracting dim
    (the attention's ``wo`` over 'model') hands back a gradient split on
    the merged dim, and splitting that into heads the mesh dim does not
    divide (qwen2's 14 over 4) is a view torch 2.11's DTensor refuses
    (a ``view``).  On a plain tensor this is the reshape."""
    from torch.distributed.tensor import DTensor

    dim = dim % x.ndim
    merged = x.reshape(*x.shape[:dim], -1, *x.shape[dim + 2:])
    if isinstance(x, DTensor) and torch.is_grad_enabled() \
            and x.requires_grad:
        merged = _GradAsInput.apply(merged)
    return merged


def constrain_kv(x):
    """Cache-copy sharding for a (B,S,Hkv,hd) tensor: batch over data
    axes; kv-heads over 'model' when divisible, else left alone.
    Applied to the COPY bound for the cache, never to the value the
    attention math consumes."""
    mesh = _ambient_mesh()
    if mesh is None:
        return x
    sizes = _axis_sizes(mesh)
    m = sizes.get("model", 1)
    h = x.shape[-2]
    h_ax = "model" if h % m == 0 else None
    if x.ndim != 4 or h_ax is None:
        return x
    return constrain(x, ("pod", "data"), None, h_ax, None)


def constrain_ssd(x):
    """(B,H,P,N) SSD state: batch over data; heads over model when
    divisible, else head_dim P."""
    mesh = _ambient_mesh()
    if mesh is None or x.ndim != 4:
        return x
    sizes = _axis_sizes(mesh)
    m = sizes.get("model", 1)
    h, p = x.shape[1], x.shape[2]
    h_ax = "model" if h % m == 0 else None
    p_ax = "model" if (h_ax is None and p % m == 0) else None
    return constrain(x, ("pod", "data"), h_ax, p_ax, None)
