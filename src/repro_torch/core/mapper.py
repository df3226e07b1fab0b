"""Layer-to-device mapping: Algorithm 1 plus a transfer-aware DP.

Two selectable policies, same output type:

``policy="greedy"`` — Algorithm 1 (paper §III-B), faithful
transcription: for each batch size, for each layer, choose the
implementation with minimum inference time (kernel + full per-layer
boundary); the batch size whose summed per-layer minima is smallest
becomes the *proper batch size*, and the per-layer argmins at that
batch size form the *Efficient Configuration*.  This prices the
paper's execution model where "data transfer between CPU and GPU takes
place before and after every layer's execution" (§IV-A).

``policy="dp"`` — transfer-aware dynamic program (Viterbi over
layers x per-layer candidate sets, run per batch size) pricing the
**fused** executor
(``mapped_model.build_mapped_model``), which elides host<->device
roundtrips between co-placed layers — the optimization the paper names
as future work.  Recurrence, with ``place(c) in {host, device}``
(``CPU`` is host, every aspect config is device)::

    dp[0][c]  = kernel(0, c) + (h2d(0) if place(c) == device)
    dp[i][c]  = kernel(i, c) + min_c' ( dp[i-1][c'] + edge(i, c', c) )
    edge(i, c', c) = h2d(i)     if host -> device
                   = d2h(i-1)   if device -> host
                   = 0          if placement unchanged
    answer    = min_c ( dp[L-1][c] + (d2h(L-1) if place(c) == device) )

Node cost is the kernel time alone; boundary cost is charged only where
the placement changes (the model starts and ends on the host).  Because
the DP minimizes the fused cost exactly, its expected time is provably
<= the greedy mapping's under the split cost model: the greedy
mapping is one feasible DP path, and its fused cost never exceeds its
paper cost (eliding transfers only removes non-negative terms).

On a legacy ``ProfileTable`` without the kernel/boundary split, every
boundary reads as zero and the DP degenerates to the greedy per-layer
argmin — the two policies agree.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

from repro_torch.core.cost_model import (
    pipeline_makespan,
    segment_times_from_split,
)
from repro_torch.core.parallel_config import is_host_config, validate
from repro_torch.core.profiler import ProfileTable

POLICIES = ("greedy", "dp")

HOST = "host"
DEVICE = "device"


@dataclasses.dataclass(frozen=True)
class Segment:
    """A maximal run of consecutive layers with the same placement.

    Segments are the unit of execution in the serving runtime
    (``repro_torch.serving``): the activation crosses the host<->device
    boundary exactly once between adjacent segments, which is the same
    set of crossings the DP mapper charges boundary cost for.
    """

    start: int            # first layer index, inclusive
    stop: int             # one past the last layer index
    placement: str        # HOST or DEVICE
    configs: tuple        # per-layer configs for layers [start, stop)

    def __len__(self) -> int:
        return self.stop - self.start

    @property
    def on_device(self) -> bool:
        return self.placement == DEVICE


def placement_of(config: str) -> str:
    """CPU (and any registered host variant) is host-placed; every
    other config — aspect or registered device variant — runs on the
    device."""
    return HOST if is_host_config(config) else DEVICE


def _candidates_for(
    table: ProfileTable, batch: int, layer: int, configs
) -> tuple:
    """The configs a policy may choose for (batch, layer): the table
    row's own (variable-size) space, optionally restricted to
    `configs`.  Restriction silently drops names the row lacks (e.g.
    autotune-pruned variants) but never yields an empty space."""
    row = table.configs_for(batch, layer)
    if configs is None:
        return row
    cand = tuple(c for c in configs if c in set(row))
    if not cand:
        raise ValueError(
            f"none of {tuple(configs)} profiled for layer {layer} "
            f"at batch {batch} (row has {row})"
        )
    return cand


def segments_of(layer_configs: Sequence[str]) -> tuple:
    """Split a per-layer config sequence into maximal same-placement
    runs.  Segment boundaries are exactly the host<->device placement
    changes — the points where the DP mapper charges an edge cost and
    where the fused/serving executors move the activation."""
    segs: list = []
    start = 0
    for i in range(1, len(layer_configs) + 1):
        if i == len(layer_configs) or (
            placement_of(layer_configs[i])
            != placement_of(layer_configs[start])
        ):
            segs.append(
                Segment(
                    start=start,
                    stop=i,
                    placement=placement_of(layer_configs[start]),
                    configs=tuple(layer_configs[start:i]),
                )
            )
            start = i
    return tuple(segs)


@dataclasses.dataclass(frozen=True)
class EfficientConfiguration:
    model_name: str
    proper_batch_size: int
    layer_labels: tuple
    layer_configs: tuple          # config per layer, paper Tables IV/V
    expected_time_per_example: float
    per_layer_times: tuple        # seconds/example at the proper batch
    policy: str = "greedy"        # mapping policy that produced this
    # kernel/boundary breakdown: per_layer_times[i] ==
    # per_layer_kernel_times[i] + per_layer_boundary_times[i]; boundary
    # is the transfer cost *charged by the policy* (full roundtrip per
    # non-CPU layer for greedy, placement-change edges only for dp)
    per_layer_kernel_times: tuple = ()
    per_layer_boundary_times: tuple = ()
    # the searchable space the mapping was chosen from: one tuple of
    # candidate variant names per layer, variable-size per layer for
    # autotuned tables.  () on legacy configurations (fixed-8 implied).
    config_space: tuple = ()
    # fused-segment selections: (start, stop, variant_name, kernel
    # s/example) per device segment whose profiled segment-scope
    # variant beat the per-layer kernel sum
    # (``core.plan.select_fused_segments``).  () = per-layer execution
    # everywhere (legacy and default).  The per-layer attribution
    # fields above are untouched by fusion — they remain the
    # per-layer price; the fused price lives on the plan's nodes.
    fused_segments: tuple = ()

    def segments(self) -> tuple:
        """Maximal same-placement layer runs (:func:`segments_of`) —
        the schedule the serving runtime executes."""
        return segments_of(self.layer_configs)

    def segment_expected_times(self) -> tuple:
        """Seconds/example per segment under the segment executor
        (``cost_model.segment_times_from_split``), aligned with
        :meth:`segments`.

        Requires the kernel/boundary split; a legacy configuration
        without it attributes everything to per_layer_times with zero
        boundary, which is still a valid split for the estimate.
        """
        kernels = self.per_layer_kernel_times or self.per_layer_times
        boundaries = self.per_layer_boundary_times or (0.0,) * len(
            self.per_layer_times
        )
        return segment_times_from_split(self.segments(), kernels, boundaries)

    def stage_times(self) -> tuple:
        """(host_s, device_s) per example: total time this
        configuration spends in host-placed vs device-placed segments,
        boundary charges counted on the device side (they serialize
        with device execution, not with host compute).

        Prices the *segment* executor, which crosses the boundary only
        at segment edges — so boundary charges on interior layers of a
        device segment are dropped.  For ``policy="dp"`` attributions
        they are zero anyway and the split is exact; for greedy
        configurations (full per-layer roundtrips) the edge layers'
        charges remain a modest upper bound (an entry layer's stored
        boundary includes a d2h the segment executor elides, and vice
        versa at exit).
        """
        host = device = 0.0
        for seg, t in zip(self.segments(), self.segment_expected_times()):
            if seg.on_device:
                device += t
            else:
                host += t
        return host, device

    def placement_shares(self) -> tuple:
        """(host_share, device_share): the fraction of this
        configuration's serial execution time spent on each processor
        (``stage_times`` normalized; sums to 1) — the tenant's demand
        profile the fleet tier charges co-tenants as contention when no
        measured shares are available.  A configuration with zero total
        time reports (0, 0)."""
        host, device = self.stage_times()
        total = host + device
        if total <= 0.0:
            return 0.0, 0.0
        return host / total, device / total

    def pipelined_expected_time(self, n_microbatches: int) -> float:
        """Expected seconds/example of the two-stage segment pipeline
        over ``n_microbatches`` micro-batches of the proper batch size
        (``cost_model.pipeline_makespan``).  With one
        micro-batch this equals ``expected_time_per_example`` for a
        DP configuration (for greedy it is lower: the segment executor
        elides the interior roundtrips greedy priced); as the stream
        grows it approaches max(host, device) per micro-batch — the
        steady-state rate the serving runtime targets."""
        host, device = self.stage_times()
        return pipeline_makespan(host, device, n_microbatches) / max(
            n_microbatches, 1
        )

    def to_json(self) -> str:
        layers = []
        for i, (label, c, t) in enumerate(
            zip(self.layer_labels, self.layer_configs, self.per_layer_times)
        ):
            entry = {"layer": label, "config": c, "time_per_example": t}
            if self.per_layer_kernel_times:
                entry["kernel_time_per_example"] = (
                    self.per_layer_kernel_times[i]
                )
                entry["boundary_time_per_example"] = (
                    self.per_layer_boundary_times[i]
                )
            if self.config_space:
                entry["candidates"] = list(self.config_space[i])
            layers.append(entry)
        doc = {
            "model": self.model_name,
            "proper_batch_size": self.proper_batch_size,
            "policy": self.policy,
            "layers": layers,
            "expected_time_per_example": self.expected_time_per_example,
        }
        if self.fused_segments:
            doc["fused_segments"] = [
                {
                    "start": s,
                    "stop": e,
                    "variant": name,
                    "kernel_time_per_example": t,
                }
                for s, e, name, t in self.fused_segments
            ]
        return json.dumps(doc, indent=2)

    @staticmethod
    def from_json(s: str) -> "EfficientConfiguration":
        """Inverse of :meth:`to_json`; tolerates legacy JSON written
        before the policy, kernel/boundary, and variable-size
        config-space (``candidates``) fields existed."""
        d = json.loads(s)
        layers = d["layers"]
        has_split = layers and "kernel_time_per_example" in layers[0]
        has_space = layers and "candidates" in layers[0]
        return EfficientConfiguration(
            model_name=d["model"],
            proper_batch_size=d["proper_batch_size"],
            layer_labels=tuple(x["layer"] for x in layers),
            layer_configs=tuple(x["config"] for x in layers),
            expected_time_per_example=d["expected_time_per_example"],
            per_layer_times=tuple(
                x["time_per_example"] for x in layers
            ),
            policy=d.get("policy", "greedy"),
            per_layer_kernel_times=tuple(
                x["kernel_time_per_example"] for x in layers
            ) if has_split else (),
            per_layer_boundary_times=tuple(
                x["boundary_time_per_example"] for x in layers
            ) if has_split else (),
            config_space=tuple(
                tuple(x["candidates"]) for x in layers
            ) if has_space else (),
            fused_segments=tuple(
                (
                    int(f["start"]),
                    int(f["stop"]),
                    f["variant"],
                    float(f["kernel_time_per_example"]),
                )
                for f in d.get("fused_segments", ())
            ),
        )


def _greedy_for_batch(
    table: ProfileTable, batch: int, configs
) -> tuple:
    """Algorithm 1 inner loop: (total, mapping).  The per-layer
    implementation space is the table row's own — variable-size for
    autotuned tables."""
    total = 0.0                         # line 4
    mapping = []
    for layer_idx in range(len(table.layer_labels)):  # line 5
        row = table.times[batch][layer_idx]
        min_time = float("inf")         # line 6
        chosen = None
        for impl in _candidates_for(table, batch, layer_idx, configs):
            t = row[impl]               # lines 8-9 (profiled)
            if t < min_time:            # line 11
                min_time = t
                chosen = impl           # line 13 (MAP impl to batch)
        total += min_time               # line 16
        mapping.append(chosen)
    return total, mapping


def _dp_for_batch(
    table: ProfileTable, batch: int, configs
) -> tuple:
    """Viterbi over layers x per-layer candidate sets under the fused
    cost model — the candidate sets may differ in size per layer
    (autotuned tables).

    Returns (total, mapping); per-layer attribution is derived from the
    mapping afterwards so kernel and edge charges stay auditable.
    """
    n_layers = len(table.layer_labels)
    cands0 = _candidates_for(table, batch, 0, configs)
    # dp cost of a prefix ending with layer i mapped to config c, the
    # activation resident at place(c); back[i][c] = best predecessor
    prev = {
        c: table.kernel_time(batch, 0, c)
        + (0.0 if is_host_config(c) else table.h2d(batch, 0))
        for c in cands0
    }
    back: list = [{c: None for c in cands0}]
    for i in range(1, n_layers):
        cur, bk = {}, {}
        d2h_prev = table.d2h(batch, i - 1)
        h2d_here = table.h2d(batch, i)
        for c in _candidates_for(table, batch, i, configs):
            dev = not is_host_config(c)
            kern = table.kernel_time(batch, i, c)
            best_cost, best_prev = float("inf"), None
            for cp, pcost in prev.items():
                if (not is_host_config(cp)) == dev:
                    edge = 0.0
                elif dev:               # host -> device: upload operand
                    edge = h2d_here
                else:                   # device -> host: download result
                    edge = d2h_prev
                cost = pcost + edge + kern
                if cost < best_cost:
                    best_cost, best_prev = cost, cp
            cur[c], bk[c] = best_cost, best_prev
        prev = cur
        back.append(bk)

    # the network's output must land back on the host
    total, last = float("inf"), None
    for c, cost in prev.items():
        if not is_host_config(c):
            cost += table.d2h(batch, n_layers - 1)
        if cost < total:
            total, last = cost, c
    mapping = [last]
    for i in range(n_layers - 1, 0, -1):
        mapping.append(back[i][mapping[-1]])
    mapping.reverse()
    return total, mapping


def attribute_fused_costs(
    table: ProfileTable, batch: int, mapping: Sequence[str]
) -> tuple:
    """(kernel, boundary) per layer for a mapping priced under the
    fused/segment executor: h2d charged to the layer entering the
    device, d2h to the layer leaving it."""
    n_layers = len(mapping)
    kernels, boundaries = [], []
    for i, c in enumerate(mapping):
        kernels.append(table.kernel_time(batch, i, c))
        b = 0.0
        if not is_host_config(c):
            entered = i == 0 or is_host_config(mapping[i - 1])
            left = i == n_layers - 1 or is_host_config(mapping[i + 1])
            if entered:
                b += table.h2d(batch, i)
            if left:
                b += table.d2h(batch, i)
        boundaries.append(b)
    return tuple(kernels), tuple(boundaries)


def map_efficient_configuration(
    table: ProfileTable,
    *,
    configs: Sequence[str] | None = None,
    policy: str = "greedy",
    batch_sizes: Sequence[int] | None = None,
) -> EfficientConfiguration:
    """Map every layer to an implementation and pick the proper batch.

    ``policy="greedy"`` is Algorithm 1 lines 1-27; ``policy="dp"`` is
    the transfer-aware Viterbi (module docstring).  Both sweep all
    profiled batch sizes and return the best.

    ``configs=None`` (default) searches each layer's full profiled
    space — the table row's own, variable-size keys, so autotuned
    tables are searched in their entirety.  Passing an explicit list
    restricts the search (e.g. ``configs=CONFIGS`` prices the paper's
    fixed-8 space on an autotuned table for apples-to-apples
    comparison).

    ``batch_sizes=None`` sweeps every profiled batch size; an explicit
    subset restricts the sweep — a remap at the batch size an engine is
    already serving keeps the batcher's padding targets valid.
    """
    if policy not in POLICIES:
        raise ValueError(
            f"unknown mapping policy {policy!r}; expected one of {POLICIES}"
        )
    if batch_sizes is None:
        batch_sizes = table.batch_sizes
    else:
        missing = tuple(
            b for b in batch_sizes if b not in table.batch_sizes
        )
        if missing:
            raise ValueError(
                f"batch sizes {missing} not profiled "
                f"(have {table.batch_sizes})"
            )
        if not batch_sizes:
            raise ValueError("batch_sizes must be non-empty when given")
    result_time = float("inf")          # line 2
    proper_batch = None                 # line 1
    best_mapping: list = []

    for batch in batch_sizes:           # line 3
        if policy == "greedy":
            total, mapping = _greedy_for_batch(table, batch, configs)
        else:
            total, mapping = _dp_for_batch(table, batch, configs)
        if total < result_time:         # line 18
            result_time = total         # line 19
            proper_batch = batch        # line 20
            best_mapping = mapping

    proper_batch = int(proper_batch)
    if policy == "greedy":
        kernels = tuple(
            table.kernel_time(proper_batch, i, c)
            for i, c in enumerate(best_mapping)
        )
        boundaries = tuple(
            table.boundary_time(proper_batch, i, c)
            for i, c in enumerate(best_mapping)
        )
    else:
        kernels, boundaries = attribute_fused_costs(
            table, proper_batch, best_mapping
        )

    return EfficientConfiguration(     # lines 23-27
        model_name=table.model_name,
        proper_batch_size=proper_batch,
        layer_labels=table.layer_labels,
        layer_configs=tuple(validate(c) for c in best_mapping),
        expected_time_per_example=result_time,
        per_layer_times=tuple(
            k + b for k, b in zip(kernels, boundaries)
        ),
        policy=policy,
        per_layer_kernel_times=kernels,
        per_layer_boundary_times=boundaries,
        config_space=tuple(
            _candidates_for(table, proper_batch, i, configs)
            for i in range(len(table.layer_labels))
        ),
    )


def price_mapping(
    table: ProfileTable,
    batch: int,
    mapping: Sequence[str],
) -> EfficientConfiguration:
    """Price an explicit per-layer mapping at `batch` under the fused
    cost model and wrap it as an EfficientConfiguration.

    For pinning a schedule by hand — serving experiments on a forced
    mixed host/device split, ablations, regression fixtures — rather
    than letting a policy choose one.  The result carries
    ``policy="dp"`` semantics: boundary cost only at placement
    changes, so ``segments()`` / the serving pipeline execute exactly
    what was priced.

    """
    if batch not in table.batch_sizes:
        raise ValueError(
            f"batch {batch} not profiled (have {table.batch_sizes})"
        )
    if len(mapping) != len(table.layer_labels):
        raise ValueError(
            f"mapping covers {len(mapping)} layers, model has "
            f"{len(table.layer_labels)}"
        )
    mapping = tuple(validate(c) for c in mapping)
    kernels, boundaries = attribute_fused_costs(table, batch, mapping)
    return EfficientConfiguration(
        model_name=table.model_name,
        proper_batch_size=int(batch),
        layer_labels=table.layer_labels,
        layer_configs=mapping,
        expected_time_per_example=sum(kernels) + sum(boundaries),
        per_layer_times=tuple(
            k + b for k, b in zip(kernels, boundaries)
        ),
        policy="dp",
        per_layer_kernel_times=kernels,
        per_layer_boundary_times=boundaries,
    )


def configuration_from_mapping(
    table: ProfileTable,
    batch: int,
    mapping: Sequence[str],
) -> EfficientConfiguration:
    """Deprecated spelling of :func:`repro_torch.api.price_mapping` —
    kept importable; warns once per call site and delegates."""
    from repro_torch._compat import warn_deprecated

    warn_deprecated("configuration_from_mapping", "price_mapping")
    from repro_torch import api

    return api.price_mapping(table, batch, mapping)


def uniform_total(table: ProfileTable, config: str, batch: int) -> float:
    """Seconds/example when every layer uses `config` at `batch` (the
    paper's naive-X / full-XYZ / CPU-only baselines, Fig. 5)."""
    validate(config)
    return sum(
        table.times[batch][i][config]
        for i in range(len(table.layer_labels))
    )


def best_uniform(table: ProfileTable, config: str) -> tuple:
    """(batch, seconds/example) of the best batch size for a uniform
    config — the strongest version of each baseline."""
    cand = [
        (uniform_total(table, config, b), b) for b in table.batch_sizes
    ]
    t, b = min(cand)
    return b, t
