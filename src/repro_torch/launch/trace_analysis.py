"""Per-device accounting of one traced step for the roofline — the
counterpart of ``repro.launch.hlo_analysis``, which parses XLA's
partitioned HLO text.  Torch has no HLO: what it emits for an SPMD step
is DTensor's dispatch on a process group, so this module reads that.

:class:`StepRecorder` is a ``TorchDispatchMode``.  It declines every op
on DTensors (returns ``NotImplemented``), so DTensor runs it and hands
the mode the per-device program it desugars into: ops on local shards
and the ``_c10d_functional`` collectives of its redistributions.  From
those it keeps:

* collective bytes and counts by the JAX package's kind names, from
  each collective's local output bytes and group size, with the
  reference's ring factors (``hlo_analysis.collective_bytes``);
* ``dot_flops``: ``torch.utils.flop_counter``'s formulas on the local
  shapes (``2 x output elements x contracted size`` for a matrix
  product; kernel 3 by its registered formula), the ops
  ``FlopCounterMode`` counts, decomposed as it decomposes them;
* ``hbm_bytes``: 2 x the local output bytes of every op that
  materialises a tensor (views and other ops whose outputs share their
  inputs' storage, factories and metadata ops are free, as
  ``hlo_analysis._FREE_OPS`` makes parameters, constants and bitcasts
  free; an in-place op counts what it writes);
* ``peak_bytes``: the high-water mark of live local storage, the
  arguments included.  A storage is live from the op that made it
  until its last tensor dies, autograd's saved tensors included: a
  finaliser on the storage object fires when the storage is freed.

Counting a global op would be a trap: a mode that took DTensor ops
whole would see (1048576, 1024) x (1024, 4096) for a product whose
local share is 1/256 of it.  DTensor's sharding propagation also runs
each new op once on global-shape fake tensors to learn its output
shape; :func:`hide_sharding_propagation` keeps those out of the counts.

The JAX package's HLO-only helpers (``parse_computations``,
``_entry_name``, ``_trip_count``, ``computation_multiplicity``,
``while_summary``) have no counterpart: eager tracing unrolls every
Python loop, so each op is seen as often as it runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "CollectiveStats",
    "StepRecorder",
    "collective_kind",
    "hide_sharding_propagation",
    "ring_bytes",
]


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))


# c10d_functional op -> the JAX package's collective kind
_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor")

# ops that produce no traffic: metadata, aliases and waits
_FREE_OPS = {
    "wait_tensor", "detach", "alias", "lift_fresh", "lift_fresh_copy",
    "_local_scalar_dense",
}
# the metadata queries FlopCounterMode declines too
_QUERY_OPS = {
    "sym_is_contiguous", "is_contiguous", "is_strides_like_format",
    "is_non_overlapping_and_dense", "size", "sym_size", "stride",
    "sym_stride", "storage_offset", "sym_storage_offset", "numel",
    "sym_numel", "dim", "layout",
}


def collective_kind(func) -> str | None:
    """The JAX package's kind name of a collective op (its own name for
    one the reference has no kind for), or None for any other op."""
    ns = func.namespace if hasattr(func, "namespace") else ""
    if ns not in _COLLECTIVE_NAMESPACES:
        return None
    name = func._overloadpacket.__name__
    if name in _KINDS:
        return _KINDS[name]
    return None if name == "wait_tensor" else name


def ring_bytes(kind: str, out_bytes: float, group: int) -> float:
    """The reference's per-device ring traffic of one collective whose
    output has `out_bytes` over a group of `group` ranks
    (``hlo_analysis.collective_bytes``): all-reduce 2(g-1)/g,
    reduce-scatter (g-1) (on the scattered output), all-gather and
    all-to-all (g-1)/g, anything else 1."""
    if kind == "all-reduce":
        return out_bytes * 2.0 * (group - 1) / max(group, 1)
    if kind == "reduce-scatter":
        return out_bytes * float(group - 1)
    if kind in ("all-gather", "all-to-all"):
        return out_bytes * (group - 1) / max(group, 1)
    return float(out_bytes)


def _group_size(func, args, kwargs) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    schema = func._schema
    named = dict(zip((a.name for a in schema.arguments), args))
    named.update(kwargs)
    if "group_size" in named:
        return int(named["group_size"])
    name = named.get("group_name", named.get("tag"))
    return _resolve_process_group(name).size()


def _tensors(tree) -> list:
    """The tensors in a tree of lists, tuples and dicts.  A loop, not a
    recursive closure: a closure that calls itself is a reference cycle,
    which would keep the tensors it saw alive until the next garbage
    collection and so overstate the peak."""
    out, todo = [], [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            todo.extend(reversed(x))
        elif isinstance(x, dict):
            todo.extend(reversed(list(x.values())))
    return out


def _aliases(outs: list, ins: list) -> bool:
    """Every output shares the storage of an input."""
    if not outs:
        return False
    have = {t.untyped_storage()._cdata for t in ins}
    return all(t.untyped_storage()._cdata in have for t in outs)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


class StepRecorder(TorchDispatchMode):
    """Records the per-device program of the ops run inside it (see the
    module docstring).  ``track(tree)`` counts tensors made before the
    block (the step's arguments) as live."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._registry = flop_registry
        self.coll_bytes: dict = defaultdict(float)
        self.coll_count: dict = defaultdict(float)
        self.dot_flops = 0
        self.hbm_bytes = 0.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict = {}
        self._hidden = 0

    # -- storage liveness ----------------------------------------------

    def _hold(self, t: torch.Tensor) -> None:
        st = _local(t).untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key)

    def _release(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def track(self, tree) -> int:
        """Count the tensors of `tree` as live; returns their unique
        local storage bytes."""
        before = self.live_bytes
        for t in _tensors(tree):
            self._hold(t)
        return self.live_bytes - before

    @property
    def collectives(self) -> CollectiveStats:
        return CollectiveStats(dict(self.coll_bytes), dict(self.coll_count))

    # -- dispatch ------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if self._hidden:
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor desugar it into local ops and collectives
            return NotImplemented
        name = func._overloadpacket.__name__
        if name in _QUERY_OPS:
            return func(*args, **kwargs)
        # decompose what FlopCounterMode decomposes, so both count the
        # same ops
        if (func not in self._registry
                and func is not torch.ops.prim.device.default):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self._account(func, name, args, kwargs, out)
        return out

    def _account(self, func, name, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if packet in self._registry:
            self.dot_flops += int(self._registry[packet](
                *args, **kwargs, out_val=out))
        outs = _tensors(out)
        out_bytes = sum(t.numel() * t.element_size() for t in outs)
        kind = collective_kind(func)
        if kind is not None:
            g = _group_size(func, args, kwargs)
            self.coll_bytes[kind] += ring_bytes(kind, out_bytes, g)
            self.coll_count[kind] += 1
        ins = _tensors((args, kwargs))
        free = (func.is_view or not ins or name in _FREE_OPS
                or func.namespace == "prim"
                or (not func._schema.is_mutable
                    and _aliases(outs, ins)))   # _unsafe_view and kin
        if not free:
            self.hbm_bytes += 2.0 * out_bytes
        for t in outs:
            self._hold(t)


@contextlib.contextmanager
def hide_sharding_propagation(recorder: StepRecorder):
    """Keep DTensor's bookkeeping out of `recorder`'s counts for the
    block: the ops it runs on global-shape fake tensors to learn an op's
    output shape (``ShardingPropagator._propagate_tensor_meta_non_
    cached``), and the index arithmetic of ``_StridedShard``'s shard
    sizes and offsets, which also runs outside the fake mode (it reads
    values back with ``tolist``, which a fake tensor cannot give)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    def hidden(fn, unfaked: bool):
        def run(*a, **kw):
            recorder._hidden += 1
            try:
                if unfaked:
                    with unset_fake_temporarily():
                        return fn(*a, **kw)
                return fn(*a, **kw)
            finally:
                recorder._hidden -= 1
        return run

    patches = [(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                False)]
    strided = getattr(placement_types, "_StridedShard", None)
    for name in ("local_shard_size_and_offset",
                 "_local_shard_size_and_offset", "_local_shard_size"):
        if strided is not None and name in strided.__dict__:
            patches.append((strided, name, True))
    saved = []
    try:
        for owner, name, unfaked in patches:
            raw = owner.__dict__[name]
            if isinstance(raw, (staticmethod, classmethod)):
                new = type(raw)(hidden(raw.__func__, unfaked))
            else:
                new = hidden(raw, unfaked)
            setattr(owner, name, new)
            saved.append((owner, name, raw))
        yield
    finally:
        for owner, name, raw in reversed(saved):
            setattr(owner, name, raw)
