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

``time_source="analytic"`` and :func:`autotune_bnn_model` are not ported
yet (ROADMAP queue 1 item 4): they raise ``NotImplementedError``.
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
from repro_torch.core.parallel_config import CONFIGS, is_host_config
from repro_torch.device import HOST, resolve_device
from repro_torch.kernels.registry import DEFAULT_REGISTRY, segment_shape_of

_NOT_PORTED = (
    "{what} is not ported yet (ROADMAP queue 1 item 4: an H100 analytic "
    "model and the registry autotune sweep); use time_source='measured'"
)


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
    # where the rows came from: "measured" (this profiler stamps its
    # time_source), or "analytic" / "predicted" on tables the JAX
    # package wrote.  None on legacy tables; additive, so the schema
    # stays at 1.
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


def _timeit(fn: Callable[[], object], repeats: int, dev: torch.device) -> float:
    """Best of `repeats` wall times after one warm-up call, each
    bracketed by a device sync when `dev` is a CUDA device."""
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


def _measured_rows(
    spec, p_host, p_dev, candidates, batch, x_host, dev, repeats, registry
):
    """(row, krow, h2d, d2h) for one layer by timing each candidate on
    its placement: host configs on CPU tensors, device configs on
    `dev`."""
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
    row, krow = {}, {}
    for cfg, (host, f, x) in runs.items():
        t = _timeit(lambda: f(x), repeats, HOST if host else dev) / batch
        krow[cfg] = t
        row[cfg] = t if host else t + h2d + d2h
    return row, krow, h2d, d2h


def _random_input(model: BNNModel, batch: int, rng) -> torch.Tensor:
    x01 = rng.random(
        (batch, *model.input_hw, model.in_channels), dtype=np.float32
    )
    return prepare_input_packed(torch.from_numpy(x01))


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
    (``None`` -> ``cuda``)."""
    if time_source == "analytic":
        raise NotImplementedError(_NOT_PORTED.format(what="analytic pricing"))
    if time_source != "measured":
        raise ValueError(f"unknown time_source {time_source!r}")
    dev = resolve_device(device)
    configs = tuple(configs)
    labels = tuple(f"L{s.idx}:{s.notation}" for s in model.specs)
    packed_host = [params_to(p, HOST) for p in packed_params]
    packed_dev = [params_to(p, dev) for p in packed_params]
    times: dict = {}
    kernel_times: dict = {}
    h2d_times: dict = {}
    d2h_times: dict = {}
    rng = np.random.default_rng(seed)
    for batch in batch_sizes:
        x_words = _random_input(model, batch, rng)
        layer_inputs = _capture_layer_inputs(model, packed_host, x_words)
        rows = [
            _measured_rows(
                spec, ph, pd, configs, batch, x_in, dev, repeats,
                DEFAULT_REGISTRY,
            )
            for spec, ph, pd, x_in in zip(
                model.specs, packed_host, packed_dev, layer_inputs
            )
        ]
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


def autotune_bnn_model(*args, **kwargs) -> ProfileTable:
    """The registry-driven autotune sweep — not ported yet."""
    raise NotImplementedError(_NOT_PORTED.format(what="autotune_bnn_model"))


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
    `device` (``None`` -> ``cuda``).  Times are kernel-only seconds per
    example: the segment's boundary transfers are unchanged by fusion
    and stay priced by the per-layer h2d/d2h rows.  Spans must be
    device-resident layer runs — typically
    ``core.plan.device_spans(config)``.
    """
    if time_source == "analytic":
        raise NotImplementedError(_NOT_PORTED.format(what="analytic pricing"))
    if time_source != "measured":
        raise ValueError(f"unknown time_source {time_source!r}")
    dev = resolve_device(device)
    reg = registry if registry is not None else DEFAULT_REGISTRY
    if batch_sizes is None:
        batch_sizes = table.batch_sizes
    packed_host = [params_to(p, HOST) for p in packed_params]
    packed_dev = [params_to(p, dev) for p in packed_params]
    rng = np.random.default_rng(seed)
    for batch in batch_sizes:
        if batch not in table.batch_sizes:
            raise ValueError(
                f"batch {batch} not profiled (have {table.batch_sizes})"
            )
        x_words = _random_input(model, batch, rng)
        layer_inputs = _capture_layer_inputs(model, packed_host, x_words)
        for start, stop in spans:
            specs = tuple(model.specs[start:stop])
            pp = packed_dev[start:stop]
            shape = segment_shape_of(specs, pp, batch)
            x_in = layer_inputs[start].to(dev)
            row = {}
            for v in reg.applicable_segments(shape, platform):
                fn = v.builder(specs, pp)
                row[v.name] = _timeit(lambda: fn(x_in), repeats, dev) / batch
            if row:
                table.add_segment_row(batch, start, stop, row)
    return table
