"""Pricing algebra and an analytic H100 model for the packed kernels.

Two halves:

* **Framework-free algebra** the mapper, the serving runtime and the
  fleet tier call: the GEMM dispatch dims of a layer and their
  loop-nest reuse traffic (``gemm_dims_for``, ``variant_analytics``,
  ``gemm_hbm_traffic``), per-segment times from a kernel/boundary split,
  per-node times of a plan, the two-stage pipeline makespan, and the
  contention pricing (``contention_inflation``, ``inflate_profile``).
  A real-valued layer (Bi-Real Net) is priced by
  ``real_layer_kernel_time_h100``: its float32 work and bytes, and a
  unit's binary conv as kernel 1's GEMM.
  These give the JAX package's results from equal inputs, except that
  ``variant_analytics`` gives the fixed 8 the port's own kernel-1 tiles,
  ``P_BLK = N_BLK = 64`` (``kernels/xnor_popcount.py``).
* **The analytic H100 model** (``*_h100``): what ``time_source=
  "analytic"`` prices when the profiler executes nothing.  A device GEMM
  is priced as the launch ``xnor_gemm_cuda`` would make
  (``launch_plan``): its grid, its block tiles and its padded
  reduction.  Parallel blocks are capped by the SM count times the 2
  blocks an SM holds (``__launch_bounds__(kThreads, 2)``,
  ``csrc/xnor_gemm.cu``); compute is the launch's bit-products over the
  1-bit MMA rate, shared out by the blocks resident at once; bytes are
  the loop-nest reuse traffic over HBM bandwidth; one launch start-up
  is added.  The times are kernel-only: the call from Python that every
  measured row also pays is not in them.

**Unvalidated.**  No constant below is fitted to a measurement of the
model's output.  ``chip_smoke.py`` phase 11 prints the model's kernel
times over the measured profile rows, per layer kind; until those
ratios stand in ``PERF.md`` §6 the model's absolute times are
unchecked.

Every device constant is for an **NVIDIA H100 80GB HBM3 (SXM), 700 W**
and names its origin: the data sheet, or a number ``chip_smoke.py``
measures on that card and ``PERF.md`` §6 records.  The host constants
are estimates for the host CPU beside the card, not measurements.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.bnn.layers import REAL_KINDS, LayerSpec
from repro_torch.core.parallel_config import CONFIGS, CPU, aspects_of
from repro_torch.kernels.xnor_popcount import (
    N_BLK,
    P_BLK,
    TILE_COLS,
    _fit_tile,
    aspect_mask,
    launch_plan,
)

# --- NVIDIA H100 80GB HBM3 (SXM), 700 W -----------------------------------
SMS = 132                 # streaming multiprocessors (data sheet, SXM5)
BLOCKS_PER_SM = 2         # __launch_bounds__(kThreads, 2), csrc/xnor_gemm.cu
HBM_BW = 3.35e12          # bytes/s, HBM3 (data sheet)
PCIE_BW = 64e9            # bytes/s each way, PCIe Gen5 x16 (data sheet:
#                           128 GB/s both ways together)
B1_RATE = 4.3e15          # bit-products/s of m16n8k256 .b1 AND/popc MMAs,
#                           measured by chip_smoke.py's xnor_mma_probe_kernel
#                           (PERF.md §6: 4.301-4.377 x 10^15)
INT32_RATE = SMS * 64 * 1.98e9  # int32 ops/s: 64 lanes an SM a clock
#                           (CUDA C++ Programming Guide, compute capability
#                           9.0) at the 1980 MHz maximum SM clock
LAUNCH_S = 2e-6           # one launch's start-up on the card (chip_smoke.py
#                           phase 7: kernel 1 at L19, PERF.md §6); a copy
#                           between host and card pays it too
# --- the host CPU beside the card (estimates, not measured) ---------------
FP32_RATE = 67e12         # FLOP/s of FP32 (data sheet, H100 SXM); a
#                           real-valued layer runs in float32, TF32 off
HOST_MEM_BW = 80e9        # bytes/s eager PyTorch reaches: 8 cores x ~10 GB/s
HOST_FP32_RATE = 2e11     # FLOP/s of float32 convs and products on the
#                           8 host cores (~25 GFLOP/s a core)
HOST_GEMM_BYTES = 300     # bytes the plain xnor GEMM (kernels/ref.py) moves
#                           per (row, neuron, word): ~19 eager ops over the
#                           (B, P, N) accumulator, most of them in int64


@dataclasses.dataclass(frozen=True)
class GemmDims:
    b: int      # batch (X axis)
    p: int      # windows per image (Y axis)
    n: int      # output neurons (Z axis)
    kw: int     # packed reduction words

    @property
    def a_bytes(self):
        return self.b * self.p * self.kw * 4

    @property
    def w_bytes(self):
        return self.n * self.kw * 4

    @property
    def o_bytes(self):
        return self.b * self.p * self.n * 4

    @property
    def vpu_ops(self):
        # xor + not + popcount + add per word pair
        return 4 * self.b * self.p * self.n * self.kw


def gemm_dims_for(spec: LayerSpec, batch: int) -> GemmDims | None:
    if spec.kind in ("conv", "bireal"):
        h, w = spec.out_shape[:2]
        cin = spec.in_shape[-1]
        return GemmDims(
            b=batch, p=h * w, n=spec.units, kw=9 * math.ceil(cin / 32)
        )
    if spec.kind == "fc":
        return GemmDims(
            b=batch, p=1, n=spec.units, kw=math.ceil(spec.in_shape[0] / 32)
        )
    return None


def _registry(registry):
    if registry is not None:
        return registry
    from repro_torch.kernels.registry import DEFAULT_REGISTRY

    return DEFAULT_REGISTRY


def variant_analytics(config: str, registry=None) -> tuple:
    """(p_blk, n_blk, kind) pricing metadata for `config`.

    Fixed-8 names price under kernel 1's own tiles (``P_BLK`` x
    ``N_BLK``, 64 x 64); registered variants carry their own tile sizes
    (``None``: kernel 1's) and traffic kind (``"tiled"`` loop-nest
    reuse, ``"fused"`` single pass, ``"host"`` CPU-side).  `registry`
    overrides the default registry for custom profiling sweeps.
    """
    if config == CPU:
        return P_BLK, N_BLK, "host"
    if config in CONFIGS:
        return P_BLK, N_BLK, "tiled"
    v = _registry(registry).get(config)
    return v.p_blk or P_BLK, v.n_blk or N_BLK, v.analytic


def _aspects_of(config: str, registry=None) -> tuple:
    if registry is not None and config not in CONFIGS and config in registry:
        return tuple(registry.get(config).aspects)
    return aspects_of(config)


def _grid(dims: GemmDims, config: str, registry=None):
    """(ordered axis names, sizes, parallel flags): aspects outermost;
    block sizes from the variant's metadata."""
    aspects = set(_aspects_of(config, registry))
    p_blk, n_blk, _ = variant_analytics(config, registry)
    sizes = {
        "X": dims.b,
        "Y": math.ceil(dims.p / min(p_blk, dims.p)),
        "Z": math.ceil(dims.n / min(n_blk, dims.n)),
    }
    order = [a for a in ("X", "Y", "Z") if a in aspects] + [
        a for a in ("X", "Y", "Z") if a not in aspects
    ]
    return order, sizes, aspects


def gemm_hbm_traffic(dims: GemmDims, config: str, registry=None) -> float:
    """Bytes moved between HBM and the blocks under the loop-nest reuse
    model: a block is (re)loaded once per iteration of every grid dim at
    or outside the innermost dim its index depends on."""
    order, sizes, _ = _grid(dims, config, registry)
    blk_p, blk_n, _ = variant_analytics(config, registry)
    p_blk, n_blk = min(blk_p, dims.p), min(blk_n, dims.n)
    deps = {"a": {"X", "Y"}, "w": {"Z"}, "o": {"X", "Y", "Z"}}
    block_bytes = {
        "a": p_blk * dims.kw * 4,
        "w": n_blk * dims.kw * 4,
        "o": p_blk * n_blk * 4,
    }
    total = 0.0
    for t, dep in deps.items():
        depth = max(order.index(d) for d in dep)
        loads = 1
        for d in order[: depth + 1]:
            loads *= sizes[d]
        total += loads * block_bytes[t]
    return total


def _is_host(config: str, registry=None) -> bool:
    from repro_torch.core.parallel_config import is_host_config

    return is_host_config(config, registry)


def gemm_launch_plan(dims: GemmDims, config: str, registry=None):
    """The ``LaunchPlan`` ``xnor_gemm_cuda`` makes for `dims` under a
    device `config` (its aspects and tiles, fitted as the wrapper fits
    them; operands taken as 16-byte aligned)."""
    p_blk, n_blk, _ = variant_analytics(config, registry)
    mask = aspect_mask(_aspects_of(config, registry))
    return launch_plan(
        dims.b, dims.p, dims.n, dims.kw, mask,
        _fit_tile(p_blk, dims.p), _fit_tile(n_blk, dims.n),
    )


def gemm_launch_bit_products(plan) -> int:
    """Bit-products the launch's MMAs compute, padding included: every
    block walks whole ``tile_rows`` x 64 tiles over the padded
    reduction (``k_steps`` of 256 bits)."""
    tiles = math.ceil(plan.rows_per_block / plan.tile_rows) * math.ceil(
        plan.cols_per_block / TILE_COLS
    )
    return plan.grid * tiles * plan.tile_rows * TILE_COLS * plan.k_steps * 256


def gemm_kernel_time_h100(dims: GemmDims, config: str, registry=None) -> float:
    """Kernel-only seconds for one xnor-GEMM dispatch under `config`, no
    host<->device transfer term.

    Device configs: the launch of ``gemm_launch_plan``; its bit-products
    over the 1-bit rate scaled by the share of the card's block slots
    (SMs x 2) the grid fills, against its loop-nest traffic over HBM,
    whichever is longer, plus one launch start-up.  ``"fused"`` variants
    move each operand once.  The host config: the plain xnor GEMM's
    eager traffic over the host's memory bandwidth.
    """
    _, _, kind = variant_analytics(config, registry)
    if kind == "host":
        return dims.b * dims.p * dims.n * dims.kw * HOST_GEMM_BYTES / (
            HOST_MEM_BW
        )
    plan = gemm_launch_plan(dims, config, registry)
    slots = SMS * BLOCKS_PER_SM
    compute = gemm_launch_bit_products(plan) / (
        B1_RATE * min(plan.grid, slots) / slots
    )
    if kind == "fused":
        traffic = dims.a_bytes + dims.w_bytes + dims.o_bytes
    else:
        traffic = gemm_hbm_traffic(dims, config, registry)
    return max(compute, traffic / HBM_BW) + LAUNCH_S


def _copy_s(n_bytes: float) -> float:
    return LAUNCH_S + n_bytes / PCIE_BW


def gemm_transfer_times_h100(dims: GemmDims) -> tuple:
    """(h2d, d2h) boundary seconds: operand upload, result download."""
    return _copy_s(dims.a_bytes), _copy_s(dims.o_bytes)


def _split(kernel: float, transfers: tuple, config: str, registry=None) -> tuple:
    """The single placement-charging rule: host placements have no
    boundary cost, device placements carry the layer's (h2d, d2h)."""
    if _is_host(config, registry):
        return kernel, 0.0, 0.0
    h2d, d2h = transfers
    return kernel, h2d, d2h


def _elems(spec: LayerSpec, batch: int) -> int:
    n = int(batch)
    for d in spec.in_shape:
        n *= int(d)
    return n


def elementwise_kernel_time_h100(
    spec: LayerSpec, config: str, batch: int, registry=None
) -> float:
    """mp / step / flat layers: memory-bound, kernel term only (each
    element read and written once, one launch on the card)."""
    bytes_ = _elems(spec, batch) * 4 * 2
    if _is_host(config, registry):
        return bytes_ / HOST_MEM_BW
    return bytes_ / HBM_BW + LAUNCH_S


def elementwise_transfer_times_h100(spec: LayerSpec, batch: int) -> tuple:
    """(h2d, d2h) for an elementwise layer (operand in, result out)."""
    n_bytes = _elems(spec, batch) * 4
    return _copy_s(n_bytes), _copy_s(n_bytes)


# eager device operations each real-valued layer's code launches
# (bnn.layers): normalize + conv; pool; sign, pack, pad, gather, GEMM,
# correction, affine, shortcut; mean; addmm
_REAL_LAUNCHES = {"stem": 4, "mpr": 1, "bireal": 12, "gap": 1, "fcr": 1}


def real_macs(spec: LayerSpec) -> int:
    """Real (float32) multiply-adds per example of a real-valued layer:
    the stem's 7x7 conv, a projecting shortcut's 1x1 conv, the
    classifier."""
    if spec.kind == "stem":
        h, w, c = spec.out_shape
        return h * w * c * 49 * spec.in_shape[-1]
    if spec.kind == "bireal" and spec.projects:
        h, w, c = spec.out_shape
        return h * w * c * spec.in_shape[-1]
    if spec.kind == "fcr":
        return spec.in_shape[0] * spec.units
    return 0


def real_io_bytes(spec: LayerSpec) -> tuple:
    """(input, output) bytes per example: uint8 pixels into the stem,
    float32 everywhere else in a real-valued network."""
    n_in = math.prod(spec.in_shape)
    return n_in * (1 if spec.kind == "stem" else 4), 4 * math.prod(
        spec.out_shape)


def real_layer_kernel_time_h100(
    spec: LayerSpec, config: str, batch: int, registry=None
) -> float:
    """Kernel-only seconds of a real-valued layer at `batch`: its float32
    multiply-adds over the FP32 rate against its bytes over HBM (each
    eager pass reads and writes its tensors), plus one start-up a launch;
    a Bi-Real unit adds its binary conv, priced as the GEMM of `config`.
    Placed on the host: the same work at the host's rates."""
    host = _is_host(config, registry)
    flops = 2.0 * real_macs(spec) * batch
    a_in, a_out = real_io_bytes(spec)
    moved = a_in + a_out
    gemm = 0.0
    if spec.kind == "stem":
        moved += 2 * 4 * math.prod(spec.in_shape)      # the float image
    elif spec.kind == "bireal":
        dims = gemm_dims_for(spec, batch)
        h, w, _ = spec.in_shape
        words = h * w * (dims.kw // 9) * 4
        # the sign read, words out and in, patches out; sums, correction,
        # affine and shortcut passes over the output
        moved += a_in + 2 * words + dims.a_bytes // batch + 3 * a_out
        gemm = gemm_kernel_time_h100(dims, config, registry)
    elif spec.kind == "fcr":
        moved += 4 * spec.in_shape[0] * spec.units    # the weights
    moved *= batch
    if host:
        return flops / HOST_FP32_RATE + moved / HOST_MEM_BW + gemm
    return (max(flops / FP32_RATE, moved / HBM_BW) + gemm
            + _REAL_LAUNCHES[spec.kind] * LAUNCH_S)


def layer_time_split_h100(
    spec: LayerSpec, config: str, batch: int, registry=None
) -> tuple:
    """(kernel_s, h2d_s, d2h_s) for one layer at `batch` (whole batch,
    not per example).  The transfer terms are placement costs of the
    layer's operand and result at their true bytes, independent of the
    aspect config; CPU placement reports zero transfer."""
    if spec.kind in REAL_KINDS:
        a_in, a_out = real_io_bytes(spec)
        return _split(
            real_layer_kernel_time_h100(spec, config, batch, registry),
            (_copy_s(batch * a_in), _copy_s(batch * a_out)),
            config,
            registry,
        )
    dims = gemm_dims_for(spec, batch)
    if dims is None:
        return _split(
            elementwise_kernel_time_h100(spec, config, batch, registry),
            elementwise_transfer_times_h100(spec, batch),
            config,
            registry,
        )
    return _split(
        gemm_kernel_time_h100(dims, config, registry),
        gemm_transfer_times_h100(dims),
        config,
        registry,
    )


def layer_time_h100(spec: LayerSpec, config: str, batch: int) -> float:
    kern, h2d, d2h = layer_time_split_h100(spec, config, batch)
    return kern + h2d + d2h


def fused_segment_kernel_time_h100(specs, batch: int) -> float:
    """Kernel-only seconds for a whole device segment as **one** launch
    (``seg_cuda``): interior activations never reach HBM, so the bytes
    are one pass over the segment's edge activations (in their edge
    encodings) plus every parameter array; the product runs at the
    1-bit rate over the whole card and the elementwise work at the int32
    rate; one launch start-up.

    Against the per-layer sum this drops each interior layer's
    activation write and read, the tile padding, the partial-card
    grids and all but one start-up, so the fused price is <= the
    per-layer kernel sum by construction.  ``segment_cuda`` today runs
    its word-ops on the popc pipe, 32x below the 1-bit rate (ROADMAP
    queue 2): this price is what the design could reach, not what the
    kernel does.
    """
    from repro_torch.kernels.segment_fused import (
        encoded_shape,
        infer_in_encoding,
        segment_out_encoding,
    )

    specs = tuple(specs)
    in_enc = infer_in_encoding(specs)
    out_enc = segment_out_encoding(specs, in_enc)

    bit_products = 0.0
    int_ops = 0.0
    param_bytes = 0.0
    for spec in specs:
        dims = gemm_dims_for(spec, batch)
        if dims is None:
            int_ops += 2 * _elems(spec, batch)
            if spec.kind == "step":
                param_bytes += spec.units * 4 * 2    # thresh + flip
        else:
            bit_products += 32 * dims.b * dims.p * dims.n * dims.kw
            param_bytes += dims.w_bytes

    def _edge_bytes(shape, enc) -> float:
        n = 1
        for d in encoded_shape(shape, enc):
            n *= d
        return batch * n * 4

    traffic = (
        _edge_bytes(specs[0].in_shape, in_enc)
        + _edge_bytes(specs[-1].out_shape, out_enc)
        + param_bytes
    )
    compute = bit_products / B1_RATE + int_ops / INT32_RATE
    return max(compute, traffic / HBM_BW) + LAUNCH_S


def plan_node_times(plan) -> tuple:
    """Seconds per plan node — the IR's own kernel/boundary annotations
    (``core.plan.build_plan`` attributes them with the same charging
    rule as :func:`segment_times_from_split`)."""
    return tuple(n.kernel_s + n.boundary_s for n in plan.nodes)


def segment_times_from_split(
    segments, kernels, boundaries
) -> tuple:
    """Seconds per segment for a configuration's kernel/boundary split.

    ``segments`` is any sequence of objects with ``start``/``stop``/
    ``on_device`` (``repro_torch.core.mapper.Segment`` duck-typed);
    ``kernels``/``boundaries`` are the per-layer attributions.  A device
    segment charges boundary only on its edge layers (interior
    roundtrips are elided by the segment executor), host segments
    charge every layer's stored boundary (zero for CPU placements by
    construction).
    """
    out = []
    for seg in segments:
        t = 0.0
        for i in range(seg.start, seg.stop):
            t += kernels[i]
            if seg.on_device:
                if i in (seg.start, seg.stop - 1):
                    t += boundaries[i]
            else:
                t += boundaries[i]
        out.append(t)
    return tuple(out)


def contention_inflation(
    co_runner_share: float, gamma: float = 1.0, *, law=None
) -> float:
    """Kernel-time inflation factor for a tenant whose co-runners
    occupy ``co_runner_share`` of a processor's time.

    Processor-sharing model: a co-runner that demands *s* seconds of a
    processor per second of wall clock stretches this tenant's kernels
    on that processor by ``1 + gamma * s``.  Linear in the share, so
    inflation is monotone: adding co-runner load never makes a
    placement look faster.

    ``law`` swaps the linear model for a calibrated one — any object
    with ``inflation(share) -> factor`` honoring the fitted-law contract
    (``repro_torch.estimator.interference``: 1 at share 0, >= 1,
    monotone non-decreasing), typically a ``FittedInterference``.  When
    given, ``gamma`` is ignored.
    """
    if law is not None:
        return float(law.inflation(max(0.0, co_runner_share)))
    if gamma < 0.0:
        raise ValueError("gamma must be non-negative")
    return 1.0 + gamma * max(0.0, co_runner_share)


def inflate_profile(
    table,
    *,
    host_factor: float = 1.0,
    device_factor: float = 1.0,
    registry=None,
):
    """A contention-inflated copy of a ``ProfileTable``: kernel times
    of host-placed configs scale by ``host_factor``, device-placed
    kernels *and* the h2d/d2h boundary rows by ``device_factor`` (a
    contended device delays its copies too).  Totals are rebuilt under
    paper semantics (device rows carry the full roundtrip).  Factors of
    1.0 return the table itself."""
    from repro_torch.core.profiler import ProfileTable

    if host_factor <= 0.0 or device_factor <= 0.0:
        raise ValueError("inflation factors must be positive")
    if host_factor == 1.0 and device_factor == 1.0:
        return table

    times: dict = {}
    kernels: dict = {}
    h2d: dict = {}
    d2h: dict = {}
    for b in table.batch_sizes:
        times[b], kernels[b] = [], []
        h2d[b] = [table.h2d(b, i) * device_factor
                  for i in range(len(table.layer_labels))]
        d2h[b] = [table.d2h(b, i) * device_factor
                  for i in range(len(table.layer_labels))]
        for i in range(len(table.layer_labels)):
            krow, trow = {}, {}
            for cfg in table.configs_for(b, i):
                host = _is_host(cfg, registry)
                k = table.kernel_time(b, i, cfg) * (
                    host_factor if host else device_factor
                )
                krow[cfg] = k
                trow[cfg] = k if host else k + h2d[b][i] + d2h[b][i]
            kernels[b].append(krow)
            times[b].append(trow)
    return ProfileTable(
        model_name=table.model_name,
        batch_sizes=table.batch_sizes,
        layer_labels=table.layer_labels,
        times=times,
        kernel_times=kernels,
        h2d_times=h2d,
        d2h_times=d2h,
    )


def pipeline_makespan(
    host_s: float, device_s: float, n_microbatches: int
) -> float:
    """Makespan of a two-stage software pipeline over a micro-batch
    stream (``repro_torch.serving.pipeline``): host stage ``host_s``,
    device stage ``device_s`` per micro-batch, overlapped across
    micro-batches::

        makespan = host_s + device_s + (n - 1) * max(host_s, device_s)
    """
    if n_microbatches <= 0:
        return 0.0
    return (
        host_s
        + device_s
        + (n_microbatches - 1) * max(host_s, device_s)
    )
