"""Segment-pipelined execution of a mapped BNN on a CPU + CUDA card.

The mapper's :meth:`EfficientConfiguration.segments` splits the layer
sequence into maximal same-placement runs; adjacent segments alternate
host <-> device, so execution is a chain

    [host seg] -> H2D -> [device seg] -> D2H -> [host seg] -> ...

:class:`SegmentPipeline` runs a *stream* of micro-batches through that
chain as a software pipeline: micro-batch ``i`` enters at wave ``i``
and advances one segment per wave, so in any wave at most one
micro-batch occupies each segment.  Within a wave, device segments are
dispatched first — their kernels are queued on the current CUDA stream
and the Python thread returns at once — and host segments run
afterwards on CPU tensors, overlapping the host work of micro-batch
*i+1* with the queued device work of micro-batch *i*.  H2D uploads are
double-buffered: micro-batch *i+1*'s input is copied from pinned host
memory with a non-blocking copy while wave *i* is still executing.  A
device segment's output is copied back with a non-blocking copy into
pinned host memory and a ``torch.cuda.Event`` recorded behind it; the
host synchronises that event only when it reads the result a wave
later.  (A non-blocking copy into pageable memory, read before a sync,
returns garbage: the buffer is always pinned and always synchronised.)

All arithmetic is int32/bool, so pipelined, serial, and fused
execution are bit-exact for the same inputs.

**Observer hook.**  Both drivers accept an ``observer`` — a callable
``observer(seg_index, segment, seconds, batch)`` fired once per
(micro-batch, segment) execution with the segment's wall time for a
``batch``-row micro-batch.  With ``observer=None`` the drivers are
exactly the un-instrumented code paths.  When observing, the pipelined
driver waits for each device segment's own output (an event recorded
on the serving stream right after the segment's launches) to read a
true wall time, which serializes that wave's device/host overlap.  It
never synchronises the whole device: work queued on other streams is
not billed to the segment.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.bnn.models import BNNModel
from repro_torch.core.mapped_model import build_node_fns, to_device
from repro_torch.core.mapper import EfficientConfiguration
from repro_torch.core.parallel_config import CPU, FULL_GPU
from repro_torch.core.plan import SegmentPlan, build_plan
from repro_torch.device import resolve_device


def canonical_mixed_mapping(model: BNNModel) -> tuple:
    """The canonical mixed host/device split for serving experiments:
    GEMM layers (conv/fc) on the device, elementwise layers on the
    host — guarantees alternating segments so the two-stage pipeline
    has work to overlap."""
    return tuple(
        FULL_GPU if s.kind in ("conv", "fc") else CPU
        for s in model.specs
    )


@dataclasses.dataclass
class _Download:
    """A device result on its way to pinned host memory."""

    host: torch.Tensor
    done: torch.cuda.Event


class SegmentPipeline:
    """Callables for a ``"segments"``-mode
    :class:`~repro_torch.core.plan.SegmentPlan`, plus serial and
    pipelined drivers over its nodes.  Device nodes run on `device`
    (``None`` -> ``cuda``), host nodes on CPU tensors."""

    def __init__(
        self,
        model: BNNModel,
        packed_params: list,
        config: EfficientConfiguration,
        *,
        device=None,
        plan: SegmentPlan | None = None,
        registry=None,
    ):
        self.device = resolve_device(device)
        self.config = config
        if plan is None:
            plan = build_plan(config, mode="segments")
        elif plan.mode != "segments":
            raise ValueError(
                f"SegmentPipeline schedules 'segments'-mode plans, "
                f"got mode {plan.mode!r}"
            )
        self.plan = plan
        self.segment_fns = build_node_fns(
            model, packed_params, config, plan, registry, device=self.device
        )

    @property
    def segments(self) -> tuple:
        return tuple(seg for seg, _ in self.segment_fns)

    def _wait_for_segment(self) -> None:
        """Block until the work queued so far on this pipeline's serving
        stream has finished: an event recorded on that stream, not a
        device-wide sync, so other streams' queued work is not waited
        for."""
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()

    def _download(self, out: torch.Tensor):
        """Start the D2H of a device segment's output."""
        if self.device.type != "cuda":
            return out
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return _Download(host, done)

    @staticmethod
    def _on_host(x) -> torch.Tensor:
        """The host tensor behind `x`, waiting for its D2H if pending."""
        if isinstance(x, _Download):
            x.done.synchronize()
            return x.host
        return x

    # -- serial reference: one micro-batch at a time, Python thread
    #    blocks at every segment boundary (no overlap) ---------------
    def run_serial(self, x_words, *, observer: Callable | None = None):
        x = torch.as_tensor(np.asarray(x_words))
        batch = x.shape[0]
        for s, (seg, fn) in enumerate(self.segment_fns):
            t0 = time.perf_counter() if observer is not None else 0.0
            if seg.on_device:
                x = fn(to_device(x, self.device)).cpu()  # D2H syncs
            else:
                x = fn(x)
            if observer is not None:
                observer(s, seg, time.perf_counter() - t0, batch)
        return x.numpy()

    # -- pipelined driver over a micro-batch stream ------------------
    def run_pipelined(
        self,
        inputs: Sequence,
        *,
        on_complete: Callable | None = None,
        observer: Callable | None = None,
    ) -> list:
        """Run `inputs` (a list of micro-batch word arrays) through the
        segment chain with a one-segment-per-wave skew.

        ``on_complete(i, out)`` fires as soon as micro-batch ``i``'s
        output is on the host — the per-micro-batch completion point
        for latency measurement.  Returns outputs (NumPy) in input
        order.
        """
        segs = self.segment_fns
        k, n = len(segs), len(inputs)
        if n == 0:
            return []
        first_on_device = segs[0][0].on_device
        state: list = [None] * n
        staged: list = [None] * n
        outputs: list = [None] * n

        def stage(i):
            # double-buffered H2D: the upload is queued a wave before
            # micro-batch i first executes
            x = torch.as_tensor(np.asarray(inputs[i]))
            staged[i] = to_device(x, self.device) if first_on_device else x

        stage(0)
        for w in range(n + k - 1):
            active = [
                (i, w - i)
                for i in range(max(0, w - k + 1), min(n - 1, w) + 1)
            ]
            if w + 1 < n:
                stage(w + 1)
            # device advances first: its kernels queue on the stream
            # while this wave's host segments run below
            for i, s in active:
                seg, fn = segs[s]
                if not seg.on_device:
                    continue
                x = staged[i] if s == 0 else state[i]
                staged[i] = None        # keep only ~2 live buffers
                if x.device != self.device:
                    x = to_device(x, self.device)
                if observer is None:
                    out = fn(x)
                else:
                    t0 = time.perf_counter()
                    out = fn(x)
                    self._wait_for_segment()
                    observer(s, seg, time.perf_counter() - t0, x.shape[0])
                state[i] = self._download(out)
            # host advances: reading a device result waits for its D2H
            for i, s in active:
                seg, fn = segs[s]
                if seg.on_device:
                    continue
                x = staged[i] if s == 0 else state[i]
                staged[i] = None
                if observer is None:
                    state[i] = fn(self._on_host(x))
                else:
                    # the timing includes the wait for the upstream D2H —
                    # the host stage pays it un-instrumented too
                    t0 = time.perf_counter()
                    xh = self._on_host(x)
                    state[i] = fn(xh)
                    observer(s, seg, time.perf_counter() - t0, xh.shape[0])
            # completions: micro-batch i leaves the pipeline
            for i, s in active:
                if s == k - 1:
                    outputs[i] = self._on_host(state[i]).numpy()
                    state[i] = None
                    if on_complete is not None:
                        on_complete(i, outputs[i])
        return outputs
