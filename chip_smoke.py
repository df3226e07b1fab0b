#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc``;
3. kernel 1, ``xnor_gemm_cuda``: all 7 aspect configurations at every
   CIFAR-10 GEMM shape, B in {1, 8}, plus a ragged shape, each
   ``torch.equal`` to the plain ``xnor_gemm_ref`` on the same inputs;
4. kernel 2, ``segment_cuda``: the whole CIFAR-10 net, a tail span that
   starts at a step and a mid span that starts at a max-pool, B in
   {1, 8}, each ``torch.equal`` to the plain ``_run_chain``;
5. main path at full width: random fp weights from NumPy seed 0 ->
   ``pack_params`` -> measured ``profile_bnn_model`` -> DP mapping ->
   ``fuse_mapping`` with ``seg_cuda`` -> a ``ServingEngine`` answering
   32 single-example requests, every answer equal to the plain CPU
   ``forward_packed``;
6. the same traffic served under two forced mappings: all layers
   ``XYZ`` with ``seg_cuda`` over the whole net, and the mixed split
   (conv/fc on the card, elementwise layers on the host); then the same
   traffic once more under each of the three mappings with the profiler
   on, for the card's busy and idle time while serving;
7. kernel timings at the main-path shapes (device time per launch from
   the profiler's trace; CUDA events for the time per call and for the
   plain versions), beside the least time the card could take.

The launch counts are zeroed just before phase 5 and read just after
phase 6's untraced serving; both kernels must have launched while
serving.  The last
lines are the device line, one JSON object with each kernel's numbers,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
PROFILE_BATCHES = (1, 4, 16)
N_REQUESTS = 32
CHECK_BATCHES = (1, 8)
# CIFAR-10 full-width GEMM shapes: (layer, P windows, N outputs, Kw, k_true)
GEMM_SHAPES = (
    ("L1", 1024, 64, 9, 27), ("L3", 1024, 64, 18, 576),
    ("L6", 256, 256, 18, 576), ("L8", 256, 256, 72, 2304),
    ("L11", 64, 512, 72, 2304), ("L13", 64, 512, 144, 4608),
    ("L17", 1, 1024, 256, 8192), ("L19", 1, 10, 32, 1024),
)
RAGGED_SHAPE = ("ragged", 37, 21, 5, 150)   # P, N not tile multiples, Kw tail
# (start, stop) layer spans of the CIFAR-10 net for the segment checks
SEGMENT_SPANS = {"whole": (0, 19), "tail from step": (14, 19),
                 "mid from mp": (8, 13)}
# Published H100 SXM rates: HBM3 bandwidth (data sheet) and POPC issue
# rate per SM per clock for compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput).
HBM_BYTES_PER_S = 3.35e12
POPC_PER_SM_PER_CLOCK = 16


def log(*args) -> None:
    print(*args, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean time per call of `fn` over `iters` back-to-back calls, from
    CUDA events, after one warm-up call: what a caller sees, host launch
    path included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, kernel: str, iters: int) -> tuple:
    """(device ms per launch of the CUDA kernel whose name contains
    `kernel`, source) over `iters` calls of `fn`, from the profiler's
    device trace; the CUDA-event time per call when the trace shows no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = n = 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            us += getattr(ev, "device_time_total", 0) or 0
            n += ev.count
    if n and us > 0:
        return us / 1e3 / n, "profiler"
    return time_ms(fn, iters), "events"


def device_trace(fn) -> tuple:
    """(wall ms, device-busy ms, {device activity: ms}) of one call of
    `fn` under the profiler: busy is the union of the intervals in which
    a kernel or a copy ran on the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        spans.append((s, e))
        name = ev.name.replace("(anonymous namespace)::", "")
        key = name.split("(")[0].split("<")[0].strip()[:40]
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e3
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return wall * 1e3, busy / 1e3, by_name


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.bnn.layers import extract_patch_words
    from repro_torch.bnn.models import (
        build_model, forward_packed, pack_params, params_to,
        prepare_input_packed, random_fp_params,
    )
    from repro_torch.core import (
        fuse_mapping, map_efficient_configuration, price_mapping,
        profile_bnn_model, profile_segment_variants,
    )
    from repro_torch.device import HOST
    from repro_torch.kernels import (
        build, launch_counts, reset_launch_counts, segment_cuda,
        xnor_gemm_cuda,
    )
    from repro_torch.kernels.ref import xnor_gemm_ref
    from repro_torch.kernels.segment_fused import (
        _run_chain, segment_gemm_work, segment_weight_bytes,
    )
    from repro_torch.serving import ServingEngine, canonical_mixed_mapping

    t_start = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    # -- 1. device ------------------------------------------------------
    device_line = smi("name,power.limit")
    log(device_line)
    max_clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    popc_per_s = n_sm * POPC_PER_SM_PER_CLOCK * max_clock_hz
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {n_sm} SMs, "
        f"max SM clock {max_clock_hz / 1e6:.0f} MHz, "
        f"popc peak {popc_per_s:.4g}/s")

    def bound(n_bytes: float, word_ops: float) -> tuple:
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = word_ops / popc_per_s * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    # -- 2. build -------------------------------------------------------
    build.build_all()
    log(f"[build] {build.build_seconds:.1f} s")
    for stem, out in build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {stem}: {line.strip()}")

    gen = torch.Generator().manual_seed(SEED)

    def words(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    # -- 3. kernel 1 against its plain version ---------------------------
    err1 = 0
    n_checks = 0
    for b in CHECK_BATCHES:
        for name, p, n, kw, k_true in GEMM_SHAPES + (RAGGED_SHAPE,):
            a, w = words(b, p, kw), words(n, kw)
            ref = xnor_gemm_ref(a, w, k_true)
            for asp in ("X", "Y", "Z", "XY", "XZ", "YZ", "XYZ"):
                out = xnor_gemm_cuda(a, w, k_true, tuple(asp))
                torch.cuda.synchronize()
                err1 = max(err1, max_abs_err(out, ref))
                if not torch.equal(out, ref):
                    raise AssertionError(
                        f"xnor_gemm_cuda {asp} B={b} {name} differs")
                n_checks += 1
    log(f"[kernel 1] xnor_gemm_cuda: {n_checks} checks torch.equal to "
        f"xnor_gemm_ref (7 aspects x {len(GEMM_SHAPES) + 1} shapes x "
        f"B in {CHECK_BATCHES}), max_abs_err {err1}")

    # -- 4. kernel 2 against its plain version ---------------------------
    model = build_model("cifar10")
    specs = model.specs
    fp = random_fp_params(specs, SEED)
    packed = pack_params(specs, fp, device=dev)

    def layer_inputs(x):
        xs = [x]
        for i in range(len(specs)):
            xs.append(_run_chain(specs[i:i + 1], packed[i:i + 1], xs[-1]))
        return xs

    def images(b):
        return torch.rand((b, *model.input_hw, model.in_channels),
                          generator=gen)

    err2 = 0
    for b in CHECK_BATCHES:
        xs = layer_inputs(prepare_input_packed(images(b)).to(dev))
        for label, (s, e) in SEGMENT_SPANS.items():
            out = segment_cuda(specs[s:e], packed[s:e])(xs[s])
            torch.cuda.synchronize()
            ref = _run_chain(specs[s:e], packed[s:e], xs[s])
            err2 = max(err2, max_abs_err(out, ref))
            if not torch.equal(out, ref):
                raise AssertionError(f"segment_cuda {label} B={b} differs")
            log(f"[kernel 2] segment_cuda {label} [{s}:{e}] B={b}: "
                f"torch.equal to _run_chain, out {tuple(out.shape)}")

    # -- 5./6. the main path: profile -> map -> fuse -> serve ------------
    rng = np.random.default_rng(SEED)
    x01 = rng.random((N_REQUESTS, *model.input_hw, model.in_channels),
                     dtype=np.float32)
    x_req = prepare_input_packed(torch.from_numpy(x01))
    t0 = time.perf_counter()
    expected = forward_packed(
        specs, [params_to(p, HOST) for p in packed], x_req).numpy()
    log(f"[main] plain CPU forward_packed of {N_REQUESTS} examples: "
        f"{time.perf_counter() - t0:.2f} s")
    if expected.shape != (N_REQUESTS, model.n_classes):
        raise AssertionError(f"reference output shape {expected.shape}")

    def serve(label, config, batch_sizes, trace=False):
        before = launch_counts()
        engine = ServingEngine(model, packed, config,
                               allowed_batch_sizes=batch_sizes, device=dev)
        engine.step(force=True)       # idle: a no-op
        reqs = [engine.submit(x_req[i].numpy()) for i in range(N_REQUESTS)]
        if trace:
            wall, busy, by_name = device_trace(lambda: engine.step(force=True))
        else:
            engine.step(force=True)
        got = np.stack([r.wait(timeout=600) for r in reqs])
        if got.shape != expected.shape or not np.array_equal(got, expected):
            raise AssertionError(f"{label}: served answers differ")
        if trace:
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            log(f"[{label}] one step of {N_REQUESTS} requests under the "
                f"profiler: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
                f"idle {100 * (1 - busy / wall):.1f}%; by activity: "
                + ", ".join(f"{k} {v:.3f} ms" for k, v in top))
            return None
        lat = np.array([r.latency_s for r in reqs]) * 1e3
        after = launch_counts()
        used = {k: after[k] - before[k] for k in after}
        log(f"[{label}] {N_REQUESTS} requests in one burst, batch "
            f"{config.proper_batch_size}: equal to plain CPU forward_packed; "
            f"latency (n={N_REQUESTS}) p50 {np.percentile(lat, 50):.3f} ms p99 "
            f"{np.percentile(lat, 99):.3f} ms; launches {used}")
        return used

    reset_launch_counts()
    t0 = time.perf_counter()
    table = profile_bnn_model(model, packed, batch_sizes=PROFILE_BATCHES,
                              device=dev)
    log(f"[main] profile_bnn_model {PROFILE_BATCHES}: "
        f"{time.perf_counter() - t0:.1f} s")
    config = map_efficient_configuration(table, policy="dp")
    config = fuse_mapping(model, packed, table, config, device=dev)
    log(f"[main] DP mapping at batch {config.proper_batch_size}, "
        f"{config.expected_time_per_example * 1e6:.3f} us/example expected: "
        + " ".join(f"{lab.split(':')[1]}={c}" for lab, c in
                   zip(config.layer_labels, config.layer_configs)))
    log(f"[main] fused spans: {[f[:3] for f in config.fused_segments]}")
    serving = [serve("serve dp", config, table.batch_sizes)]

    batch = config.proper_batch_size
    whole = (0, len(specs))
    profile_segment_variants(model, packed, table, spans=(whole,),
                             batch_sizes=(batch,), device=dev)
    forced = price_mapping(table, batch, ("XYZ",) * len(specs))
    forced = dataclasses.replace(forced, fused_segments=(
        (*whole, "seg_cuda", table.segment_time(batch, *whole, "seg_cuda")),
    ))
    serving.append(serve("serve forced seg_cuda", forced, table.batch_sizes))
    mixed = price_mapping(table, batch, canonical_mixed_mapping(model))
    serving.append(serve("serve forced mixed", mixed, table.batch_sizes))
    main_counts = launch_counts()
    log(f"[main] launches over phases 5-6: {main_counts}")
    for name in ("xnor_gemm_cuda", "segment_cuda"):
        if sum(u[name] for u in serving) == 0:
            raise AssertionError(f"{name} never launched while serving")
    # where the serving time goes: the same traffic once more per mapping,
    # traced (after the counts are read, so these launches are not counted)
    for label, cfg in (("trace dp", config), ("trace forced seg_cuda", forced),
                       ("trace forced mixed", mixed)):
        serve(label, cfg, table.batch_sizes, trace=True)

    # -- 7. timings at the main-path shapes ------------------------------
    xs = layer_inputs(prepare_input_packed(images(batch)).to(dev))
    rows = []
    for i, spec in enumerate(specs):
        if spec.kind not in ("conv", "fc"):
            continue
        x = xs[i]
        a = (extract_patch_words(x).reshape(batch, spec.in_shape[0]
             * spec.in_shape[1], -1) if spec.kind == "conv" else x[:, None, :])
        a = a.contiguous()
        w, k_true = packed[i]["w_words"], packed[i]["k_true"]
        n, kw = w.shape
        work = a.shape[0] * a.shape[1] * n * kw
        n_bytes = 4 * (a.numel() + w.numel() + a.shape[0] * a.shape[1] * n)
        ms, how = kernel_ms(lambda: xnor_gemm_cuda(a, w, k_true),
                            "xnor_gemm_kernel", 50)
        call = time_ms(lambda: xnor_gemm_cuda(a, w, k_true), 50)
        plain = time_ms(lambda: xnor_gemm_ref(a, w, k_true), 3)
        b_ms, b_by = bound(n_bytes, work)
        rows.append((ms, plain, n_bytes, work))
        log(f"[time] xnor_gemm_cuda XYZ L{spec.idx} B={batch} "
            f"P={a.shape[1]} N={n} Kw={kw}: device {ms:.5f} ms ({how}), "
            f"per call {call:.5f} ms, plain {plain:.3f} ms, bound "
            f"{b_ms:.5f} ms ({b_by})")
        if spec.idx == 8:
            per_cfg = {asp: kernel_ms(
                lambda asp=asp: xnor_gemm_cuda(a, w, k_true, tuple(asp)),
                "xnor_gemm_kernel", 20)[0] for asp in
                ("X", "Y", "Z", "XY", "XZ", "YZ", "XYZ")}
            log(f"[time] xnor_gemm_cuda L8 B={batch} device ms by aspect "
                "config: " + " ".join(f"{k}={v:.5f}" for k, v in
                                      per_cfg.items()))
    k1_ms, k1_plain = sum(r[0] for r in rows), sum(r[1] for r in rows)
    k1_bound, k1_by = bound(sum(r[2] for r in rows), sum(r[3] for r in rows))

    seg = segment_cuda(specs, packed)
    k2_ms, how = kernel_ms(lambda: seg(xs[0]), "segment_kernel", 20)
    k2_call = time_ms(lambda: seg(xs[0]), 20)
    k2_plain = time_ms(lambda: _run_chain(specs, packed, xs[0]), 3)
    n_bytes = 4 * (xs[0].numel() + xs[-1].numel()) + segment_weight_bytes(
        packed)
    k2_bound, k2_by = bound(n_bytes, segment_gemm_work(specs, packed, batch))
    log(f"[time] segment_cuda whole net B={batch}: device {k2_ms:.4f} ms "
        f"({how}), per call {k2_call:.4f} ms, plain {k2_plain:.3f} ms, "
        f"bound {k2_bound:.5f} ms ({k2_by})")
    x1 = xs[0][:1].contiguous()
    log(f"[time] segment_cuda whole net B=1: device "
        f"{kernel_ms(lambda: seg(x1), 'segment_kernel', 20)[0]:.4f} ms")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    kernels = [
        {"name": "xnor_gemm_cuda", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/xnor_gemm.cu",
         "replaces": "src/repro/kernels/xnor_popcount.py:61",
         "launches": main_counts["xnor_gemm_cuda"], "max_abs_err": err1,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "segment_cuda", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/segment_fused.cu",
         "replaces": "src/repro/kernels/segment_fused.py:223",
         "launches": main_counts["segment_cuda"], "max_abs_err": err2,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]
    log(device_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
