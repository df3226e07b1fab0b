"""Build executables from an EfficientConfiguration — the torch analogue
of the paper's generated CUDA/C++ (§III-E), around the
:mod:`repro_torch.core.plan` IR.

There is **one** executor.  Every execution style is a plan shape, not
a separate driver:

    config --build_plan(mode)--> SegmentPlan --build_node_fns--> fns
                                                     |
                                              run_plan(fns)

* ``build_mapped_model(fused=True)`` — the ``"whole"`` plan: one node
  spanning the network, each layer on its own placement, the activation
  moved only where placement changes.
* ``build_mapped_model(fused=False)`` — per-layer plan nodes with a
  sync after every node: mode ``"layers"`` crosses the host boundary
  only at placement changes (the elision the DP priced), mode
  ``"roundtrip"`` round-trips around every device layer (paper §IV-A).
* ``build_segment_fns`` — the ``"segments"`` plan: one callable per
  same-placement segment, consumed by the serving pipeline
  (``repro_torch.serving.pipeline.SegmentPipeline``).

Placement is physical: a host node's layers run on CPU tensors with CPU
copies of their parameters, a device node's on `device` with device
copies (made once, when the node functions are built).  A node with a
``fused_variant`` runs the segment-scope kernel from the variant
registry (one launch, activations bit-packed between its layers); any
other node composes its layers' implementations in plain Python —
torch runs eagerly, there is nothing to compile.  All arithmetic is
integer/bool, so every form is bit-exact.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.bnn.models import BNNModel, params_to
from repro_torch.core.mapper import EfficientConfiguration
from repro_torch.core.parallel_config import is_host_config
from repro_torch.core.plan import SegmentPlan, build_plan
from repro_torch.core.profiler import layer_fn
from repro_torch.device import HOST, resolve_device
from repro_torch.kernels.registry import DEFAULT_REGISTRY, SCOPE_SEGMENT


def _layer_fn(spec, packed, config: str, registry=None) -> Callable:
    """The layer's computation under `config`, resolved through the
    kernel-variant registry; `packed` already lies on the layer's
    placement."""
    reg = registry if registry is not None else DEFAULT_REGISTRY
    builder = reg.get(config).builder if spec.kind in ("conv", "fc") else None
    return layer_fn(spec, packed, builder)


def _placed(config: str, device: torch.device) -> torch.device:
    return HOST if is_host_config(config) else device


def build_node_fns(
    model: BNNModel,
    packed_params: list,
    config: EfficientConfiguration,
    plan: SegmentPlan,
    registry=None,
    *,
    device=None,
) -> list:
    """One callable per plan node, in execution order:
    ``[(PlanNode, fn), ...]``.

    A node carrying a ``fused_variant`` resolves that segment-scope
    variant's builder over the node's layer slice (one fused launch);
    any other node composes its layers' per-layer implementations, each
    on its own placement.
    """
    dev = resolve_device(device)
    reg = registry if registry is not None else DEFAULT_REGISTRY
    placed = [_placed(c, dev) for c in config.layer_configs]
    params = [params_to(p, d) for p, d in zip(packed_params, placed)]
    out = []
    for node in plan.nodes:
        sl = slice(node.start, node.stop)
        if node.fused_variant is not None:
            variant = reg.get(node.fused_variant)
            if variant.scope != SCOPE_SEGMENT:
                raise ValueError(
                    f"plan node [{node.start}:{node.stop}] names "
                    f"{node.fused_variant!r} as fused variant, but its "
                    f"registry scope is {variant.scope!r}"
                )
            fn = variant.builder(
                tuple(model.specs[sl]), params[sl], node.in_encoding
            )
        else:
            fn = _compose([
                (d, _layer_fn(spec, p, cfg, registry))
                for spec, p, cfg, d in zip(
                    model.specs[sl], params[sl],
                    config.layer_configs[sl], placed[sl],
                )
            ])
        out.append((node, fn))
    return out


def _compose(placed_fns) -> Callable:
    """Run `placed_fns` ``[(device, fn), ...]`` in order, moving the
    activation only where the placement changes."""
    placed_fns = tuple(placed_fns)

    def fn(x):
        for d, f in placed_fns:
            if x.device != d:
                x = x.to(d)
            x = f(x)
        return x

    return fn


def to_device(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """H2D from pinned host memory, queued on the current stream."""
    if dev.type == "cuda":
        return x.pin_memory().to(dev, non_blocking=True)
    return x.to(dev)


def run_plan(node_fns, *, device=None) -> Callable:
    """The plan interpreter: ``fn(x_words) -> CPU tensor`` walking the
    nodes with the transfer/sync structure the plan encodes — H2D
    (pinned, non-blocking) before a ``transfer_in`` node, a device sync
    after every node (the per-node cost structure the profiler
    measured), D2H (``.cpu()``) after a ``transfer_out`` node.  Between
    co-placed nodes the activation stays where it is."""
    dev = resolve_device(device)

    def run(x_words):
        x = torch.as_tensor(x_words)     # input starts on the host
        for node, fn in node_fns:
            if node.transfer_in and x.device != dev:
                x = to_device(x, dev)
            x = fn(x)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if node.transfer_out:
                x = x.cpu()
        return x.cpu()

    return run


def build_mapped_model(
    model: BNNModel,
    packed_params: list,
    config: EfficientConfiguration,
    *,
    fused: bool = True,
    elide_transfers: bool | None = None,
    registry=None,
    device=None,
) -> Callable:
    """Returns fn(packed_input_words) -> int32 class scores (CPU
    tensor), executing each layer with its mapped implementation on its
    placement (`device` for device configs, ``None`` -> ``cuda``).

    ``fused=True`` runs the ``"whole"`` plan: one node, no per-node
    syncs or interior host roundtrips.

    ``elide_transfers`` applies to the faithful (``fused=False``)
    driver only: ``True`` (plan mode ``"layers"``) crosses the host
    boundary solely where consecutive layers change placement,
    ``False`` (mode ``"roundtrip"``) round-trips around every non-CPU
    layer (paper §IV-A).  ``None`` follows the mapping policy — DP
    configurations were priced under elision.
    """
    dev = resolve_device(device)
    if fused:
        plan = build_plan(config, mode="whole")
    else:
        if elide_transfers is None:
            elide_transfers = getattr(config, "policy", "greedy") == "dp"
        plan = build_plan(
            config, mode="layers" if elide_transfers else "roundtrip"
        )
    node_fns = build_node_fns(
        model, packed_params, config, plan, registry, device=dev
    )
    return run_plan(node_fns, device=dev)


def build_segment_fns(
    model: BNNModel,
    packed_params: list,
    config: EfficientConfiguration,
    registry=None,
    *,
    device=None,
) -> list:
    """One callable per segment of `config`, in execution order —
    the ``"segments"`` plan's node functions, ``[(PlanNode, fn), ...]``.
    Device segments selected for fusion (``config.fused_segments``) run
    as one fused kernel launch; everything else composes the per-layer
    implementations."""
    plan = build_plan(config, mode="segments")
    return build_node_fns(
        model, packed_params, config, plan, registry, device=device
    )
