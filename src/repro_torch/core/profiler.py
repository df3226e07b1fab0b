"""Per-layer latency profiling (paper §III-A, Fig. 4) on torch.

:func:`profile_bnn_model` is the paper's sweep: for every batch size and
every layer, time a fixed candidate list (default ``CPU`` + the 7 aspect
configs) and store the result in a :class:`ProfileTable` — the same
schema and JSON as the JAX package's, so a table written by either
package loads in the other.

**Where each candidate runs.**  On a CUDA device the host/device split is
physical: the ``CPU`` config runs the plain implementation on CPU
tensors, every aspect config launches the CUDA xnor GEMM on ``cuda``
tensors (elementwise layers run their torch ops on the device).  Device
timings are bracketed by ``torch.cuda.synchronize()``; host timings need
no sync.

**Kernel/boundary time model.**  Each entry is split into ``kernel`` (the
layer's compute alone, wherever it is placed) and ``boundary`` — the
layer operand's host->device upload (timed from pinned host memory) and
the result's device->host download (timed into pinned host memory),
stored per layer in ``h2d_times`` / ``d2h_times``.  The paper-faithful
total (``times``) charges device-placed layers ``kernel + h2d + d2h``;
the DP mapper prices boundary only where placement changes.

Times are stored **seconds per example**, so totals are comparable
across batch sizes.

Two entry points, one ``ProfileTable`` output: :func:`profile_bnn_model`
(the fixed candidate list) and :func:`autotune_bnn_model` — per-layer
candidates from the kernel-variant registry filtered by each GEMM
layer's shape and the platform, so rows are variable-size (always a
superset of the fixed 8).  In measured mode every candidate gets a
one-repeat warm-up timing first, and extended variants dominated by
``prune_factor`` x the best warm-up are dropped before the full sweep;
the fixed 8 are never pruned.

``time_source="measured"`` times the candidates on the card (or on CPU
tensors with ``device="cpu"``); ``"analytic"`` prices them with the H100
model (``core.cost_model``, ``*_h100``) and executes nothing, so it needs
no card.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.bnn import layers as L
from repro_torch.bnn.models import BNNModel, params_to, prepare_input_packed
from repro_torch.core import cost_model as cm
from repro_torch.core.parallel_config import CONFIGS, is_host_config
from repro_torch.device import HOST, resolve_device
from repro_torch.kernels.registry import (
    DEFAULT_REGISTRY,
    GemmShape,
    segment_shape_of,
)

TIME_SOURCES = ("measured", "analytic")


@dataclasses.dataclass
class ProfileTable:
    model_name: str
    batch_sizes: tuple
    layer_labels: tuple          # e.g. ('L1:C64', 'L2:MP14', ...)
    # times[batch][layer_idx][config] -> seconds per example, paper
    # semantics: kernel + full per-layer boundary for device configs.
    # Rows are dicts keyed by variant name, so per-layer config spaces
    # may differ in size (autotuned tables) — consumers must iterate
    # row keys (``configs_for``), never assume the fixed 8.
    times: dict
    # kernel_times[batch][layer_idx][config] -> kernel-only s/example
    kernel_times: dict | None = None
    # h2d_times/d2h_times[batch][layer_idx] -> boundary s/example for
    # the layer's operand upload / result download (config-independent)
    h2d_times: dict | None = None
    d2h_times: dict | None = None
    # segment_times[batch]["start:stop"][variant] -> kernel s/example
    # for a whole device segment executed as one fused dispatch
    # (segment-scope variants, ``repro_torch.kernels.segment_fused``) —
    # the candidate rows ``core.plan.select_fused_segments`` compares
    # against the span's per-layer kernel sum
    segment_times: dict | None = None
    # where the rows came from: "measured" / "analytic" (the profiler
    # stamps its time_source) or "predicted" (synthesized by
    # repro_torch.estimator.LatencyPredictor with zero profiling
    # passes).  None on legacy tables; additive, so the schema stays
    # at 1.
    provenance: str | None = None

    @staticmethod
    def span_key(start: int, stop: int) -> str:
        return f"{start}:{stop}"

    def segment_variants_for(
        self, batch: int, start: int, stop: int
    ) -> tuple:
        """Segment-scope variant names profiled for the span at
        `batch` (``()`` when the span was never segment-profiled)."""
        if self.segment_times is None:
            return ()
        row = self.segment_times.get(batch, {}).get(
            self.span_key(start, stop)
        )
        return tuple(row) if row else ()

    def segment_time(
        self, batch: int, start: int, stop: int, variant: str
    ) -> float:
        return self.segment_times[batch][self.span_key(start, stop)][
            variant
        ]

    def add_segment_row(
        self, batch: int, start: int, stop: int, row: dict
    ) -> None:
        """Record (merge) a span's segment-variant timings at `batch`."""
        if self.segment_times is None:
            self.segment_times = {}
        self.segment_times.setdefault(batch, {}).setdefault(
            self.span_key(start, stop), {}
        ).update(row)

    def configs_for(self, batch: int, layer: int) -> tuple:
        """The candidate config names profiled for (batch, layer) —
        the layer's searchable space, variable-size by design."""
        return tuple(self.times[batch][layer])

    def best_config(self, batch: int, layer: int) -> tuple:
        row = self.times[batch][layer]
        cfg = min(row, key=row.get)
        return cfg, row[cfg]

    # -- split accessors (legacy tables without the split degrade to
    #    kernel == total, boundary == 0, under which the DP mapper
    #    reproduces the greedy mapping exactly) ----------------------
    def kernel_time(self, batch: int, layer: int, config: str) -> float:
        if self.kernel_times is not None:
            return self.kernel_times[batch][layer][config]
        return self.times[batch][layer][config]

    def h2d(self, batch: int, layer: int) -> float:
        if self.h2d_times is None:
            return 0.0
        return self.h2d_times[batch][layer]

    def d2h(self, batch: int, layer: int) -> float:
        if self.d2h_times is None:
            return 0.0
        return self.d2h_times[batch][layer]

    def boundary_time(self, batch: int, layer: int, config: str) -> float:
        """Full per-layer roundtrip charged under paper semantics."""
        if is_host_config(config):
            return 0.0
        return self.h2d(batch, layer) + self.d2h(batch, layer)

    # -- JSON round-trip (mirrors the EfficientConfiguration
    #    conventions: versioned schema, legacy-tolerant loader) -------
    SCHEMA_VERSION = 1

    def to_json(self) -> str:
        """Serialize the table, kernel/boundary split included when
        present.  Batch keys are stringified (JSON object keys);
        :meth:`from_json` restores them to ints."""

        def by_batch(d):
            return (
                None if d is None else {str(b): d[b] for b in sorted(d)}
            )

        return json.dumps(
            {
                "schema": self.SCHEMA_VERSION,
                "kind": "profile_table",
                "model": self.model_name,
                "batch_sizes": list(self.batch_sizes),
                "layer_labels": list(self.layer_labels),
                "times": by_batch(self.times),
                "kernel_times": by_batch(self.kernel_times),
                "h2d_times": by_batch(self.h2d_times),
                "d2h_times": by_batch(self.d2h_times),
                "segment_times": by_batch(self.segment_times),
                "provenance": self.provenance,
            },
            indent=2,
        )

    @staticmethod
    def from_json(s: str) -> "ProfileTable":
        """Inverse of :meth:`to_json`.  Legacy-tolerant: a document
        without the ``schema``/``kind`` envelope (or without the
        kernel/boundary split fields) still loads — missing split
        components degrade exactly like a pre-split in-memory table
        (kernel == total, boundary == 0).  A document from a *newer*
        schema than this code understands is refused rather than
        silently misread."""
        d = json.loads(s)
        schema = d.get("schema", 1)
        if schema > ProfileTable.SCHEMA_VERSION:
            raise ValueError(
                f"profile_table schema {schema} is newer than supported "
                f"({ProfileTable.SCHEMA_VERSION}); upgrade the loader"
            )
        kind = d.get("kind", "profile_table")
        if kind != "profile_table":
            raise ValueError(f"expected a profile_table document, got {kind!r}")

        def by_batch(key):
            raw = d.get(key)
            return (
                None if raw is None else {int(b): raw[b] for b in raw}
            )

        return ProfileTable(
            model_name=d["model"],
            batch_sizes=tuple(int(b) for b in d["batch_sizes"]),
            layer_labels=tuple(d["layer_labels"]),
            times=by_batch("times"),
            kernel_times=by_batch("kernel_times"),
            h2d_times=by_batch("h2d_times"),
            d2h_times=by_batch("d2h_times"),
            segment_times=by_batch("segment_times"),
            provenance=d.get("provenance"),
        )


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timeit(
    fn: Callable[[], object], repeats: int, dev: torch.device,
    warm: bool = True,
) -> float:
    """Best of `repeats` wall times after one warm-up call (none with
    ``warm=False``), each bracketed by a device sync when `dev` is a
    CUDA device."""
    if warm:
        fn()  # warm-up (the first CUDA launch also builds the kernels)
        _sync(dev)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def _measure_h2d(x_host: torch.Tensor, dev: torch.device, repeats: int) -> float:
    """Host->device upload of a layer's operand, from pinned memory."""
    src = x_host.pin_memory() if dev.type == "cuda" else x_host
    return _timeit(lambda: src.to(dev, non_blocking=True), repeats, dev)


def _measure_d2h(x_dev: torch.Tensor, repeats: int) -> float:
    """Device->host download of a layer's result, into pinned memory."""
    dev = x_dev.device
    if dev.type != "cuda":
        return _timeit(lambda: x_dev.to(HOST), repeats, dev)
    dst = torch.empty(x_dev.shape, dtype=x_dev.dtype, pin_memory=True)
    return _timeit(lambda: dst.copy_(x_dev, non_blocking=True), repeats, dev)


def layer_fn(spec: L.LayerSpec, packed: dict, builder=None) -> Callable:
    """The layer's computation with `packed` params (already on the
    device the layer runs on); GEMM layers go through the variant's
    `builder` ``(a, w, k_true) -> out``."""
    if spec.kind == "conv":
        w, k_true = packed["w_words"], packed["k_true"]

        def conv(x):
            b, h, ww, _ = x.shape
            p = L.extract_patch_words(x).reshape(b, h * ww, -1)
            return builder(p, w, k_true).reshape(b, h, ww, -1)

        return conv
    if spec.kind == "fc":
        w, k_true = packed["w_words"], packed["k_true"]
        return lambda x: builder(x[:, None, :], w, k_true)[:, 0, :]
    if spec.kind == "mp":
        return L.maxpool_packed
    if spec.kind == "step":
        t, fl = packed["thresh"], packed["flip"]
        return lambda x: L.step_packed(x, t, fl)
    if spec.kind == "flat":
        c = spec.in_shape[-1]
        return lambda x: L.flat_packed(x, c)
    raise ValueError(spec.kind)


def _capture_layer_inputs(
    model: BNNModel, packed_host: list, x_words: torch.Tensor
) -> list:
    """Run the plain forward on host tensors, returning each layer's
    input."""
    builder = DEFAULT_REGISTRY.get("CPU").builder
    xs = []
    x = x_words
    for spec, p in zip(model.specs, packed_host):
        xs.append(x)
        x = layer_fn(spec, p, builder)(x)
    return xs


def prune_survivors(
    warmups: dict, *, never_prune=CONFIGS, prune_factor: float = 3.0
) -> tuple:
    """Autotune pruning decision: given one-repeat warm-up timings
    (name -> seconds), keep every name in `never_prune` plus any
    variant within ``prune_factor`` x the fastest warm-up.  Dominated
    extended variants are skipped for the full-repeats sweep (and
    dropped from the profile row)."""
    if not warmups:
        return ()
    best = min(warmups.values())
    keep = set(never_prune)
    return tuple(
        name
        for name, t in warmups.items()
        if name in keep or t <= prune_factor * best
    )


def gemm_shape_of(spec: L.LayerSpec, packed: dict, batch: int):
    """The GEMM dispatch shape of a conv/fc layer at `batch` (None for
    elementwise layers) — what variant applicability predicates see."""
    if spec.kind not in ("conv", "fc"):
        return None
    w_words = packed["w_words"]
    n, kw = int(w_words.shape[0]), int(w_words.shape[1])
    if spec.kind == "conv":
        h, w, _ = spec.in_shape
        return GemmShape(b=batch, p=h * w, n=n, kw=kw)
    return GemmShape(b=batch, p=1, n=n, kw=kw)


def _analytic_rows(spec, candidates, batch, registry):
    """(row, krow, h2d, d2h) for one layer from the H100 model."""
    row, krow = {}, {}
    h2d = d2h = 0.0
    for cfg in candidates:
        kern, th2d, td2h = cm.layer_time_split_h100(
            spec, cfg, batch, registry=registry
        )
        krow[cfg] = kern / batch
        row[cfg] = (kern + th2d + td2h) / batch
        if not is_host_config(cfg, registry):
            h2d, d2h = th2d / batch, td2h / batch
    return row, krow, h2d, d2h


def _measured_rows(
    spec, p_host, p_dev, candidates, batch, x_host, dev, repeats,
    prune_factor, registry,
):
    """(row, krow, h2d, d2h) for one layer by timing each candidate on
    its placement: host configs on CPU tensors, device configs on
    `dev`.

    Every candidate gets a warm-up call and one timed call first; with
    ``prune_factor`` set, extended variants dominated by
    ``prune_factor`` x that time of the best candidate are dropped, and
    the survivors get ``repeats - 1`` more timed calls (each row is the
    best of ``repeats``).
    """
    x_dev = x_host.to(dev)
    runs = {}
    for cfg in candidates:
        host = is_host_config(cfg, registry)
        builder = (
            registry.get(cfg).builder if spec.kind in ("conv", "fc") else None
        )
        f = layer_fn(spec, p_host if host else p_dev, builder)
        runs[cfg] = (host, f, x_host if host else x_dev)
    _, f0, x0 = runs[candidates[0]]
    x_out_dev = f0(x0).to(dev)
    h2d = _measure_h2d(x_host, dev, repeats) / batch
    d2h = _measure_d2h(x_out_dev, repeats) / batch

    def timed(cfg, n, warm=True):
        host, f, x = runs[cfg]
        return _timeit(lambda: f(x), n, HOST if host else dev, warm)

    warmups = {cfg: timed(cfg, 1) for cfg in candidates}
    if prune_factor is not None:
        survivors = prune_survivors(
            warmups, never_prune=CONFIGS, prune_factor=prune_factor
        )
    else:
        survivors = tuple(candidates)
    row, krow = {}, {}
    for cfg in survivors:
        t = warmups[cfg]
        if repeats > 1:
            t = min(t, timed(cfg, repeats - 1, warm=False))
        t /= batch
        krow[cfg] = t
        row[cfg] = t if runs[cfg][0] else t + h2d + d2h
    return row, krow, h2d, d2h


def _random_input(model: BNNModel, batch: int, rng) -> torch.Tensor:
    x01 = rng.random(
        (batch, *model.input_hw, model.in_channels), dtype=np.float32
    )
    return prepare_input_packed(torch.from_numpy(x01))


def _check_time_source(time_source: str) -> None:
    if time_source not in TIME_SOURCES:
        raise ValueError(f"unknown time_source {time_source!r}")


def _profile(
    model: BNNModel,
    packed_params: list,
    candidates_fn: Callable,
    *,
    batch_sizes: Sequence[int],
    repeats: int,
    seed: int,
    time_source: str,
    prune_factor: float | None,
    registry,
    device,
) -> ProfileTable:
    """Shared sweep: ``candidates_fn(spec, packed, batch) -> names``
    decides each layer's searchable space.  Analytic mode executes
    nothing and so resolves no device."""
    _check_time_source(time_source)
    labels = tuple(f"L{s.idx}:{s.notation}" for s in model.specs)
    packed_host = [params_to(p, HOST) for p in packed_params]
    if time_source == "measured":
        dev = resolve_device(device)
        packed_dev = [params_to(p, dev) for p in packed_params]
    times: dict = {}
    kernel_times: dict = {}
    h2d_times: dict = {}
    d2h_times: dict = {}
    rng = np.random.default_rng(seed)
    for batch in batch_sizes:
        if time_source == "measured":
            x_words = _random_input(model, batch, rng)
            layer_inputs = _capture_layer_inputs(
                model, packed_host, x_words
            )
        rows = []
        for i, (spec, ph) in enumerate(zip(model.specs, packed_host)):
            candidates = tuple(candidates_fn(spec, ph, batch))
            if time_source == "analytic":
                rows.append(_analytic_rows(spec, candidates, batch, registry))
            else:
                rows.append(_measured_rows(
                    spec, ph, packed_dev[i], candidates, batch,
                    layer_inputs[i], dev, repeats, prune_factor, registry,
                ))
        times[batch] = [r[0] for r in rows]
        kernel_times[batch] = [r[1] for r in rows]
        h2d_times[batch] = [r[2] for r in rows]
        d2h_times[batch] = [r[3] for r in rows]
    return ProfileTable(
        model.name,
        tuple(batch_sizes),
        labels,
        times,
        kernel_times=kernel_times,
        h2d_times=h2d_times,
        d2h_times=d2h_times,
        provenance=time_source,
    )


def profile_bnn_model(
    model: BNNModel,
    packed_params: list,
    *,
    batch_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128),
    configs: Sequence[str] = CONFIGS,
    repeats: int = 3,
    seed: int = 0,
    time_source: str = "measured",
    device=None,
) -> ProfileTable:
    """The paper's fixed-space sweep: every layer is timed under the
    same candidate list (default CPU + 7 aspect configs) at every batch
    size, host configs on CPU tensors and device configs on `device`
    (``None`` -> ``cuda``), or priced by the H100 model
    (``time_source="analytic"``, no device needed)."""
    configs = tuple(configs)
    return _profile(
        model,
        packed_params,
        lambda spec, packed, batch: configs,
        batch_sizes=batch_sizes,
        repeats=repeats,
        seed=seed,
        time_source=time_source,
        prune_factor=None,
        registry=DEFAULT_REGISTRY,
        device=device,
    )


def autotune_bnn_model(
    model: BNNModel,
    packed_params: list,
    *,
    registry=None,
    batch_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128),
    repeats: int = 3,
    seed: int = 0,
    time_source: str = "measured",
    prune_factor: float = 3.0,
    platform: str | None = None,
    device=None,
) -> ProfileTable:
    """Registry-driven autotune sweep with variable per-layer spaces.

    GEMM layers are timed under the fixed-8 configs **plus** every
    registered variant whose applicability predicate accepts the
    layer's dispatch shape on `platform`; elementwise layers keep the
    fixed 8 (only placement matters there).  Measured mode times on
    `device` (``None`` -> ``cuda``) and prunes dominated extended
    variants after a one-repeat warm-up (:func:`prune_survivors`); the
    fixed 8 are always fully timed, so any mapping feasible in the
    paper's space remains feasible in the autotuned table.

    ``platform=None`` resolves to the measuring device's type in
    measured mode (``"cuda"`` or ``"cpu"``) and to ``"cuda"`` in
    analytic mode: the analytic sweep prices the card even on a host
    without one.
    """
    _check_time_source(time_source)
    reg = registry if registry is not None else DEFAULT_REGISTRY
    if platform is None:
        platform = (
            "cuda" if time_source == "analytic"
            else resolve_device(device).type
        )

    def candidates(spec, packed, batch):
        shape = gemm_shape_of(spec, packed, batch)
        if shape is None:
            return CONFIGS
        extra = tuple(
            v.name
            for v in reg.applicable(shape, platform)
            if v.name not in CONFIGS
        )
        return CONFIGS + extra

    return _profile(
        model,
        packed_params,
        candidates,
        batch_sizes=batch_sizes,
        repeats=repeats,
        seed=seed,
        time_source=time_source,
        prune_factor=prune_factor if time_source == "measured" else None,
        registry=reg,
        device=device,
    )


def profile_segment_variants(
    model: BNNModel,
    packed_params: list,
    table: ProfileTable,
    *,
    spans: Sequence[tuple],
    batch_sizes: Sequence[int] | None = None,
    registry=None,
    time_source: str = "measured",
    repeats: int = 3,
    seed: int = 0,
    platform: str | None = None,
    device=None,
) -> ProfileTable:
    """Time fused whole-segment execution over `spans` and record the
    rows on ``table.segment_times`` (the table is updated in place and
    returned).

    For each ``(start, stop)`` span and batch size, every segment-scope
    registry variant whose applicability predicate accepts the span's
    :class:`~repro_torch.kernels.registry.SegmentShape` is timed on
    `device` (``None`` -> ``cuda``), or priced by the H100 model
    (``time_source="analytic"``: ``"fused"`` variants by
    ``cost_model.fused_segment_kernel_time_h100``; executes nothing, and
    ``platform=None`` means ``"cuda"``).  Times are kernel-only seconds
    per example: the segment's boundary transfers are unchanged by
    fusion and stay priced by the per-layer h2d/d2h rows.  Spans must be
    device-resident layer runs — typically
    ``core.plan.device_spans(config)``.
    """
    _check_time_source(time_source)
    measured = time_source == "measured"
    reg = registry if registry is not None else DEFAULT_REGISTRY
    if batch_sizes is None:
        batch_sizes = table.batch_sizes
    packed_host = [params_to(p, HOST) for p in packed_params]
    if measured:
        dev = resolve_device(device)
        packed_dev = [params_to(p, dev) for p in packed_params]
    elif platform is None:
        platform = "cuda"
    rng = np.random.default_rng(seed)
    for batch in batch_sizes:
        if batch not in table.batch_sizes:
            raise ValueError(
                f"batch {batch} not profiled (have {table.batch_sizes})"
            )
        if measured:
            x_words = _random_input(model, batch, rng)
            layer_inputs = _capture_layer_inputs(
                model, packed_host, x_words
            )
        for start, stop in spans:
            specs = tuple(model.specs[start:stop])
            shape = segment_shape_of(specs, packed_host[start:stop], batch)
            if measured:
                x_in = layer_inputs[start].to(dev)
            row = {}
            for v in reg.applicable_segments(shape, platform):
                if not measured:
                    if v.analytic != "fused":
                        raise ValueError(
                            f"segment variant {v.name!r}: the H100 model "
                            f"prices only 'fused' segments, not "
                            f"{v.analytic!r}"
                        )
                    t = cm.fused_segment_kernel_time_h100(specs, batch)
                else:
                    fn = v.builder(specs, packed_dev[start:stop])
                    t = _timeit(lambda: fn(x_in), repeats, dev)
                row[v.name] = t / batch
            if row:
                table.add_segment_row(batch, start, stop, row)
    return table
