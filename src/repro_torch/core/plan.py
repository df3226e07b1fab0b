"""Segment execution plan IR — the typed object every executor runs.

HEP-BNN's unit of reasoning is the *same-placement segment*
(``mapper.segments_of``): the mapper prices boundary transfers only
where placement changes, and the serving pipeline moves activations
only at segment edges.  This module makes that schedule an explicit,
inspectable IR instead of a convention each driver re-implements:

    EfficientConfiguration --build_plan()--> SegmentPlan
                                                |
              mapped_model.build_node_fns / run_plan (one executor)
                                                |
                   serving.SegmentPipeline  /  tests

A :class:`SegmentPlan` is a sequence of :class:`PlanNode`\\ s.  Each
node carries

* ``placement`` + ``transfer_in``/``transfer_out`` — where the node
  runs and whether the activation crosses the host<->device boundary
  at its edges.  Transfers appear **only at placement changes** (plus
  the paper's per-layer roundtrip mode), never inside a node.
* ``ops`` — the node's :class:`LayerOp`\\ s, each annotated with its
  activation *encoding* on entry and exit: ``"packed"`` (int32
  bitplane words, 32 binary activations per word) or ``"unpacked"``
  (one int32 pre-activation per element).  Encodings are derived from
  the layer kinds (conv/fc consume packed and produce unpacked
  pre-activations; step thresholds unpacked back to packed; mp
  preserves; flat reshapes packed), and :func:`build_plan` *proves*
  the chain is consistent: adjacent ops always agree, so no executor
  ever packs/unpacks between layers — an encoding conversion happens
  exactly once, inside the op that changes it.  A layer sequence whose
  encodings cannot chain raises :class:`PlanError` instead of
  executing garbage.
* ``kernel_s`` / ``boundary_s`` — the priced cost of the node, the
  same attribution ``cost_model.segment_times_from_split`` charges
  (boundary only on device-segment edge layers).
* ``fused_variant`` — optionally, the name of a *segment-scope* kernel
  variant (``repro_torch.kernels.segment_fused``) that executes the
  whole node as one fused kernel launch with activations staying
  bit-packed; ``None`` composes the per-layer implementations.

Build modes (``build_plan(config, mode=...)``) reproduce every
pre-existing driver as a plan shape rather than separate code paths:

* ``"segments"`` (default) — one node per same-placement segment; the
  schedule the DP priced and the serving pipeline runs.
* ``"layers"`` — one node per layer, transfers only at placement
  changes (the faithful driver with elision).
* ``"roundtrip"`` — one node per layer, device nodes transfer on both
  sides (paper §IV-A's per-layer roundtrip execution model).
* ``"whole"`` — a single node spanning the network; each layer runs on
  its own placement and the node moves the activation where placement
  changes.

Fused-variant selection (:func:`select_fused_segments`) compares each
device segment's per-layer kernel sum against the profiled
segment-variant times in the :class:`ProfileTable` and records the
winners on ``EfficientConfiguration.fused_segments`` — taking the
minimum, so a fused plan is never priced worse than per-layer
execution (the per-layer composition is always a candidate).
"""

from __future__ import annotations

import dataclasses
import json

from repro_torch.core.mapper import (
    DEVICE,
    HOST,
    EfficientConfiguration,
)

PACKED = "packed"        # int32 bitplane words, 32 activations/word
UNPACKED = "unpacked"    # one int32 pre-activation per element

MODES = ("segments", "layers", "roundtrip", "whole")


class PlanError(ValueError):
    """The layer sequence (or plan input) cannot form a valid plan —
    e.g. adjacent layers whose activation encodings cannot chain."""


def kind_of_label(label: str) -> str:
    """Layer kind from a profile label (``"L3:MP14" -> "mp"``).  The
    token after ``Li:`` is the paper's notation; prefix-matched with
    the longer tokens first so ``FLAT``/``FC`` never read as conv."""
    token = label.split(":", 1)[-1]
    for prefix, kind in (
        ("MP", "mp"), ("FLAT", "flat"), ("FC", "fc"),
        ("C", "conv"), ("S", "step"),
    ):
        if token.startswith(prefix):
            return kind
    raise PlanError(f"unrecognized layer label {label!r}")


# (in_encoding, out_encoding) demanded/produced by each kind; mp is
# absent because it preserves whatever encoding flows in
_KIND_ENCODINGS = {
    "conv": (PACKED, UNPACKED),
    "fc": (PACKED, UNPACKED),
    "step": (UNPACKED, PACKED),
    "flat": (PACKED, PACKED),
}


def layer_encodings(kinds) -> tuple:
    """Per-layer (in_encoding, out_encoding) for a kind sequence,
    chained from the packed network input (``prepare_input_packed``).
    Raises :class:`PlanError` where a layer's required input encoding
    does not match its predecessor's output — such a sequence has no
    bit-exact executor (feeding unpacked pre-activations to a packed
    GEMM computes garbage), so it must not silently build."""
    out = []
    cur = PACKED
    for i, kind in enumerate(kinds):
        if kind == "mp":
            out.append((cur, cur))
            continue
        if kind not in _KIND_ENCODINGS:
            raise PlanError(f"unknown layer kind {kind!r} at layer {i}")
        need, prod = _KIND_ENCODINGS[kind]
        if cur != need:
            raise PlanError(
                f"encoding mismatch at layer {i} ({kind}): requires "
                f"{need} input but predecessor produces {cur}; insert "
                f"a step layer (unpacked->packed) to rebinarize"
            )
        out.append((need, prod))
        cur = prod
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class LayerOp:
    """One layer inside a plan node."""

    index: int            # layer index in the model
    kind: str             # conv | mp | step | flat | fc
    config: str           # kernel-variant / aspect-config name
    in_encoding: str      # PACKED or UNPACKED
    out_encoding: str

    @property
    def converts(self) -> bool:
        """True when this op changes the activation encoding — the
        (only) place a pack/unpack cost is ever paid."""
        return self.in_encoding != self.out_encoding


@dataclasses.dataclass(frozen=True)
class PlanNode:
    """A schedulable unit: layers [start, stop) on one placement.

    Duck-types ``mapper.Segment`` (``start``/``stop``/``placement``/
    ``configs``/``on_device``/``__len__``), so every segment consumer
    — pipeline observers, ``cost_model.segment_times_from_split`` —
    works on plan nodes unchanged.
    """

    start: int
    stop: int
    placement: str        # mapper.HOST or mapper.DEVICE
    ops: tuple            # LayerOp per layer in [start, stop)
    transfer_in: bool     # H2D before the node runs
    transfer_out: bool    # D2H after the node runs
    kernel_s: float = 0.0      # priced kernel seconds/example
    boundary_s: float = 0.0    # priced transfer seconds/example
    fused_variant: str | None = None   # segment-scope kernel, or None

    def __len__(self) -> int:
        return self.stop - self.start

    @property
    def on_device(self) -> bool:
        return self.placement == DEVICE

    @property
    def configs(self) -> tuple:
        return tuple(op.config for op in self.ops)

    @property
    def in_encoding(self) -> str:
        return self.ops[0].in_encoding

    @property
    def out_encoding(self) -> str:
        return self.ops[-1].out_encoding

    @property
    def time_s(self) -> float:
        return self.kernel_s + self.boundary_s


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    model_name: str
    batch: int
    policy: str
    mode: str             # one of MODES
    nodes: tuple          # PlanNode, in execution order

    @property
    def n_layers(self) -> int:
        return self.nodes[-1].stop if self.nodes else 0

    @property
    def expected_time_per_example(self) -> float:
        return sum(n.time_s for n in self.nodes)

    def node_times(self) -> tuple:
        return tuple(n.time_s for n in self.nodes)

    def stage_times(self) -> tuple:
        """(host_s, device_s) per example over the plan's nodes."""
        host = device = 0.0
        for n in self.nodes:
            if n.on_device:
                device += n.time_s
            else:
                host += n.time_s
        return host, device

    def ops(self) -> tuple:
        """All LayerOps in layer order."""
        return tuple(op for n in self.nodes for op in n.ops)

    def to_json(self) -> str:
        return json.dumps(
            {
                "model": self.model_name,
                "batch": self.batch,
                "policy": self.policy,
                "mode": self.mode,
                "nodes": [
                    {
                        "start": n.start,
                        "stop": n.stop,
                        "placement": n.placement,
                        "transfer_in": n.transfer_in,
                        "transfer_out": n.transfer_out,
                        "kernel_s": n.kernel_s,
                        "boundary_s": n.boundary_s,
                        "fused_variant": n.fused_variant,
                        "ops": [
                            {
                                "index": op.index,
                                "kind": op.kind,
                                "config": op.config,
                                "in": op.in_encoding,
                                "out": op.out_encoding,
                            }
                            for op in n.ops
                        ],
                    }
                    for n in self.nodes
                ],
            },
            indent=2,
        )

    @staticmethod
    def from_json(s: str) -> "SegmentPlan":
        d = json.loads(s)
        nodes = tuple(
            PlanNode(
                start=nd["start"],
                stop=nd["stop"],
                placement=nd["placement"],
                ops=tuple(
                    LayerOp(
                        index=op["index"],
                        kind=op["kind"],
                        config=op["config"],
                        in_encoding=op["in"],
                        out_encoding=op["out"],
                    )
                    for op in nd["ops"]
                ),
                transfer_in=nd["transfer_in"],
                transfer_out=nd["transfer_out"],
                kernel_s=nd["kernel_s"],
                boundary_s=nd["boundary_s"],
                fused_variant=nd.get("fused_variant"),
            )
            for nd in d["nodes"]
        )
        return SegmentPlan(
            model_name=d["model"],
            batch=d["batch"],
            policy=d["policy"],
            mode=d["mode"],
            nodes=nodes,
        )


def encoding_conversions(plan: SegmentPlan) -> tuple:
    """Where the plan changes activation encoding: one
    ``(layer_index, from, to)`` per converting op.  Conversions live
    *inside* ops — never between them — so this is also exactly the
    set of pack/unpack costs the plan charges (each op's conversion is
    folded into its kernel time, priced once)."""
    return tuple(
        (op.index, op.in_encoding, op.out_encoding)
        for op in plan.ops()
        if op.converts
    )


def boundary_encoding_changes(plan: SegmentPlan) -> tuple:
    """Encoding changes at op *boundaries* — adjacent ops whose
    encodings disagree.  Always ``()`` for a plan built by
    :func:`build_plan` (the chain-consistency invariant: co-placed
    adjacent layers never unpack/repack between them); exposed so
    tests can assert it on arbitrary plans."""
    ops = plan.ops()
    return tuple(
        (a.index, a.out_encoding, b.in_encoding)
        for a, b in zip(ops, ops[1:])
        if a.out_encoding != b.in_encoding
    )


def _node_boundary(boundaries, start, stop, on_device) -> float:
    """The transfer seconds a segment-shaped node charges: device
    nodes pay only their edge layers' attributions (interior
    roundtrips are elided by construction — the single charging rule
    of ``cost_model.segment_times_from_split``), host nodes pay every
    layer's stored boundary (zero for CPU placements)."""
    if on_device:
        edges = {start, stop - 1}
        return sum(boundaries[i] for i in edges)
    return sum(boundaries[start:stop])


def build_plan(
    config: EfficientConfiguration, *, mode: str = "segments"
) -> SegmentPlan:
    """Lower an ``EfficientConfiguration`` to a :class:`SegmentPlan`.

    The plan is the *single* description of execution: which layers
    run where, where the activation crosses the host<->device
    boundary, what encoding it has at every point, and what each node
    is priced at.  ``config.fused_segments`` entries matching a device
    node's span (``"segments"`` mode) set that node's
    ``fused_variant`` and replace its kernel price with the profiled
    fused time.
    """
    if mode not in MODES:
        raise PlanError(f"unknown plan mode {mode!r}; expected {MODES}")
    labels = config.layer_labels
    n = len(labels)
    kinds = tuple(kind_of_label(x) for x in labels)
    encs = layer_encodings(kinds)
    kernels = config.per_layer_kernel_times or config.per_layer_times
    boundaries = config.per_layer_boundary_times or (0.0,) * n
    ops = tuple(
        LayerOp(
            index=i,
            kind=kinds[i],
            config=config.layer_configs[i],
            in_encoding=encs[i][0],
            out_encoding=encs[i][1],
        )
        for i in range(n)
    )
    fused = {
        (int(s), int(e)): (name, float(t))
        for s, e, name, t in getattr(config, "fused_segments", ())
    }

    nodes = []
    if mode == "whole":
        on_device = any(
            seg.on_device for seg in config.segments()
        )
        nodes.append(
            PlanNode(
                start=0,
                stop=n,
                placement=DEVICE if on_device else HOST,
                ops=ops,
                transfer_in=False,
                transfer_out=False,
                kernel_s=sum(kernels),
                boundary_s=sum(boundaries),
            )
        )
    elif mode == "segments":
        for seg in config.segments():
            variant, kern = None, sum(kernels[seg.start:seg.stop])
            if seg.on_device and (seg.start, seg.stop) in fused:
                variant, kern = fused[(seg.start, seg.stop)]
            nodes.append(
                PlanNode(
                    start=seg.start,
                    stop=seg.stop,
                    placement=seg.placement,
                    ops=ops[seg.start:seg.stop],
                    transfer_in=seg.on_device,
                    transfer_out=seg.on_device,
                    kernel_s=kern,
                    boundary_s=_node_boundary(
                        boundaries, seg.start, seg.stop, seg.on_device
                    ),
                    fused_variant=variant,
                )
            )
    else:  # per-layer nodes: "layers" (elided) or "roundtrip" (§IV-A)
        placements = [
            seg.placement
            for seg in config.segments()
            for _ in range(len(seg))
        ]
        for i in range(n):
            dev = placements[i] == DEVICE
            if mode == "roundtrip":
                t_in = t_out = dev
            else:
                t_in = dev and (i == 0 or placements[i - 1] == HOST)
                t_out = dev and (
                    i == n - 1 or placements[i + 1] == HOST
                )
            nodes.append(
                PlanNode(
                    start=i,
                    stop=i + 1,
                    placement=placements[i],
                    ops=(ops[i],),
                    transfer_in=t_in,
                    transfer_out=t_out,
                    kernel_s=kernels[i],
                    boundary_s=boundaries[i],
                )
            )

    plan = SegmentPlan(
        model_name=config.model_name,
        batch=config.proper_batch_size,
        policy=config.policy,
        mode=mode,
        nodes=tuple(nodes),
    )
    assert boundary_encoding_changes(plan) == (), (
        "plan invariant violated: encoding change between adjacent ops"
    )
    return plan


def device_spans(config: EfficientConfiguration) -> tuple:
    """(start, stop) of every device-placed segment — the fusion
    candidates :func:`select_fused_segments` prices."""
    return tuple(
        (seg.start, seg.stop)
        for seg in config.segments()
        if seg.on_device
    )


def select_fused_segments(
    config: EfficientConfiguration,
    table,
    *,
    registry=None,
) -> EfficientConfiguration:
    """Pick, per device segment, the cheapest execution the table
    knows: the per-layer kernel composition (always a candidate) or a
    profiled segment-scope variant.  Returns a configuration whose
    ``fused_segments`` records each strict winner — so the fused
    plan's priced time is **<=** the per-layer plan's (min over a
    superset that contains the per-layer option).

    Only variants present in `registry` (default: the process-wide
    ``DEFAULT_REGISTRY``) are eligible — a table profiled under a
    richer registry never selects a variant the executor can't build.
    """
    if registry is None:
        from repro_torch.kernels.registry import DEFAULT_REGISTRY

        registry = DEFAULT_REGISTRY
    batch = config.proper_batch_size
    kernels = config.per_layer_kernel_times or config.per_layer_times
    chosen = []
    for start, stop in device_spans(config):
        per_layer = sum(kernels[start:stop])
        best_name, best_t = None, per_layer
        for name in table.segment_variants_for(batch, start, stop):
            if name not in registry:
                continue
            t = table.segment_time(batch, start, stop, name)
            if t < best_t:
                best_name, best_t = name, t
        if best_name is not None:
            chosen.append((start, stop, best_name, best_t))
    return dataclasses.replace(config, fused_segments=tuple(chosen))


def fuse_mapping(
    model,
    packed_params,
    table,
    config: EfficientConfiguration,
    *,
    registry=None,
    time_source: str = "measured",
    repeats: int = 3,
    platform: str | None = None,
    device=None,
) -> EfficientConfiguration:
    """Profile every applicable segment-scope variant over `config`'s
    device segments on `device` (``None`` -> ``cuda``;
    ``profiler.profile_segment_variants``) and select the winners — the
    one-call path from a mapped configuration to a fused one.  The
    table is updated in place with the segment rows."""
    from repro_torch.core.profiler import profile_segment_variants

    profile_segment_variants(
        model,
        packed_params,
        table,
        spans=device_spans(config),
        batch_sizes=(config.proper_batch_size,),
        registry=registry,
        time_source=time_source,
        repeats=repeats,
        platform=platform,
        device=device,
    )
    return select_fused_segments(config, table, registry=registry)


def fuse_configuration(
    model,
    packed_params,
    table,
    config: EfficientConfiguration,
    **kwargs,
) -> EfficientConfiguration:
    """Deprecated spelling of :func:`repro_torch.api.fuse_mapping` —
    kept importable; warns once per call site and delegates."""
    from repro_torch._compat import warn_deprecated

    warn_deprecated("fuse_configuration", "fuse_mapping")
    from repro_torch import api

    return api.fuse_mapping(model, packed_params, table, config, **kwargs)
