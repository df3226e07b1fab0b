"""Segment-pipelined execution of a mapped BNN on a CPU + CUDA card.

The mapper's :meth:`EfficientConfiguration.segments` splits the layer
sequence into maximal same-placement runs; adjacent segments alternate
host <-> device, so execution is a chain

    [host seg] -> H2D -> [device seg] -> D2H -> [host seg] -> ...

:class:`SegmentPipeline` runs a *stream* of micro-batches through that
chain as a software pipeline: micro-batch ``i`` enters at wave ``i``
and advances one segment per wave, so in any wave at most one
micro-batch occupies each segment.  Within a wave, device segments are
dispatched first — their work is queued on the current CUDA stream and
the Python thread returns at once — and host segments run afterwards on
CPU tensors, overlapping the host work of micro-batch *i+1* with the
queued device work of micro-batch *i*.

**The graph path.**  A device segment that is one fused launch of a
segment-scope kernel (its plan node carries a ``fused_variant``), or a
run of real-valued layers (Bi-Real Net's kinds, which no segment-scope
kernel lowers; eagerly each layer is a dozen or more launches, and the
host's launch path, not the card, would set the pace), on a CUDA
device, with the callable this pipeline built (not one wrapped after
the build), is served by captured CUDA graphs.  At the first
micro-batch of each batch size the pipeline runs one eager launch of
that size (it loads the kernel library and caches what the launch asks
of the card), then captures a *ring* of ``RING_SLOTS`` slots for it.
A slot holds a pinned host input, the device input, a pinned host
output, an event and a graph over H2D -> the segment's launch -> D2H;
the launch's output and scratch live in the graph's private pool.  A
micro-batch is served by copying its words into the next slot's pinned
input, replaying the slot's graph and recording its event: no
allocation, no Python launch path.  Its result is read — the event
waited on, then the rows **copied out** of the slot into an array of
the caller's own — only after the next micro-batch's replay is queued,
so the card runs one micro-batch while the host finishes the previous
one.  The copy-out is what lets the slot be reused: a caller keeps its
answers as long as it likes without holding pinned memory, and a slot
is written again only after the result it held has been read, which the
one-wave lag guarantees with two slots.  A capture launches nothing:
the wrappers' launch counters (``repro_torch.kernels.launch_counts``,
and the Bi-Real unit's two kernels') are put back after it, and each
replay adds what its capture counted, so ``segment_cuda.launches``
still counts one per micro-batch (and ``xnor_gemm_cuda.launches``,
``bireal_patches_cuda.launches`` and ``bireal_epilogue_cuda.launches``
one per Bi-Real unit).  A replay runs none of
its layers' Python, so it records no ``layer.run`` spans.

Every other device segment runs **eagerly**, as it always did:
per-layer device segments of the packed grammar, callables wrapped
after the build (e.g. to inject contention), and every segment on a
CPU device.  Its input is uploaded from pinned host memory with a
non-blocking copy a wave ahead (double-buffered), and its output is
copied back with a non-blocking copy into a fresh pinned buffer with a
``torch.cuda.Event`` recorded behind it; the host synchronises that
event only when it reads the result.  The pipeline's own outputs are
copied out of that buffer, as out of a ring slot, so a caller keeps
its answers without holding pinned memory, and the host allocator
reuses the buffer.  (A non-blocking copy into pageable memory, read
before a sync, returns garbage: the buffer is always pinned and always
synchronised.)

``counts`` (:class:`GraphCounts`) counts graphs captured, their
replays and device segments run eagerly; an engine passes one object
to every pipeline it builds, so they survive swaps.

All arithmetic of the packed grammar is int32/bool, so pipelined,
serial, graphed and fused execution are bit-exact for the same inputs;
a real-valued segment's graph replays the kernels its eager launch
runs.

**Observer hook.**  :meth:`SegmentPipeline.run_pipelined` accepts an
``observer`` — a callable ``observer(seg_index, segment, seconds,
batch)`` fired once per (micro-batch, segment) execution with the
segment's wall time for a ``batch``-row micro-batch.  When observing,
it waits for each device segment's own output (an event recorded on the
serving stream right after the segment's launches, or after its
replay, whose time then includes its copies) to read a true wall time,
which serializes that wave's device/host overlap.  It never
synchronises the whole device: work queued on other streams is not
billed to the segment.

**Spans.**  With :mod:`repro_torch.spans` recording, ``run_pipelined``
records, without waiting on the card: ``pipeline.stage`` (an input made
a tensor and queued H2D, or copied into a ring slot; micro-batch,
segment index), ``pipeline.launch`` (a device segment's host path up to
its launches' return, or a replay and its event; micro-batch, segment
index), ``pipeline.host`` (a host segment; the same),
``pipeline.download`` (pinned buffer, D2H and event queued; from a
ring slot or a last segment's buffer, the rows copied out once its event
is waited on; micro-batch) and ``pipeline.d2h_wait`` (the host blocked on a result's
event; micro-batch).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import spans
from repro_torch.bnn.layers import REAL_KINDS
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


RING_SLOTS = 2            # graphs a (device segment, batch size) cycles


def counted_kernels() -> tuple:
    """The wrappers whose launches a replay adds back: ``KERNELS``, and
    the Bi-Real unit's two (``UNIT_KERNELS``), which ``launch_counts()``
    leaves out."""
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.bireal_unit import UNIT_KERNELS

    return KERNELS + UNIT_KERNELS


def uncounted(capture: Callable, times: int) -> tuple:
    """(what `capture()` returns, ``[(wrapper, launches a replay
    makes)]``): `capture` records a replay's launches `times` times
    over; every counted wrapper's count is put back after it."""
    kernels = counted_kernels()
    before = [k.launches for k in kernels]
    try:
        got = capture()
        launches = [(k, (k.launches - n) // times)
                    for k, n in zip(kernels, before) if k.launches > n]
    finally:
        for k, n in zip(kernels, before):
            k.launches = n
    return got, launches


@dataclasses.dataclass
class GraphCounts:
    """How a pipeline's device segments were served, per (micro-batch,
    device segment): ``graph_replays`` from a captured graph,
    ``eager_device_segments`` eagerly; ``graph_captures`` counts the
    graphs captured."""

    graph_captures: int = 0
    graph_replays: int = 0
    eager_device_segments: int = 0


@dataclasses.dataclass
class _Download:
    """A device result on its way to pinned host memory."""

    host: torch.Tensor
    done: torch.cuda.Event


@dataclasses.dataclass
class _Slot:
    """One place in a ring: a captured H2D -> segment -> D2H over its
    own buffers, and the event recorded behind its last replay."""

    x: np.ndarray             # view of the pinned input
    host_in: torch.Tensor
    dev_in: torch.Tensor
    host_out: torch.Tensor
    graph: torch.cuda.CUDAGraph
    done: torch.cuda.Event


@dataclasses.dataclass
class _Ring:
    """The slots of one (device segment, batch size), taken in turn, and
    the launches a replay makes, ``[(wrapper, count)]``."""

    slots: list
    launches: list
    next: int = 0

    def take(self) -> _Slot:
        slot = self.slots[self.next]
        self.next = (self.next + 1) % len(self.slots)
        return slot


class SegmentPipeline:
    """Callables for a ``"segments"``-mode
    :class:`~repro_torch.core.plan.SegmentPlan`, plus serial and
    pipelined drivers over its nodes.  Device nodes run on `device`
    (``None`` -> ``cuda``), host nodes on CPU tensors; ``counts`` is
    the :class:`GraphCounts` to add to (a fresh one by default)."""

    def __init__(
        self,
        model: BNNModel,
        packed_params: list,
        config: EfficientConfiguration,
        *,
        device=None,
        plan: SegmentPlan | None = None,
        registry=None,
        counts: GraphCounts | None = None,
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
        self._built = tuple(fn for _, fn in self.segment_fns)
        self._real = tuple(all(op.kind in REAL_KINDS for op in node.ops)
                           for node, _ in self.segment_fns)
        self.counts = GraphCounts() if counts is None else counts
        self._rings: dict = {}   # (segment index, batch) -> _Ring

    @property
    def segments(self) -> tuple:
        return tuple(seg for seg, _ in self.segment_fns)

    def _graphed(self, s: int) -> bool:
        """Whether segment `s` is served by captured graphs: one fused
        launch, or real-valued layers only, on a CUDA device, through
        the callable built here."""
        node, fn = self.segment_fns[s]
        return (
            self.device.type == "cuda"
            and node.on_device
            and (node.fused_variant is not None or self._real[s])
            and fn is self._built[s]
        )

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
    def _on_host(x, i: int, output: bool = False) -> torch.Tensor:
        """The host tensor behind `x` (micro-batch `i`), waiting for its
        D2H if pending; a ring slot's result, and a download that is the
        pipeline's `output`, are copied out of their pinned memory."""
        if isinstance(x, (_Download, _Slot)):
            sp = spans.open("pipeline.d2h_wait", i) if spans.on else None
            x.done.synchronize()
            if sp is not None:
                spans.close(sp)
            pinned = x.host_out if isinstance(x, _Slot) else x.host
            if isinstance(x, _Slot) or output:
                sp = spans.open("pipeline.download", i) if spans.on else None
                out = torch.from_numpy(pinned.numpy().copy())
                if sp is not None:
                    spans.close(sp)
                return out
            return pinned
        return x

    def _capture(self, s: int, x) -> _Ring:
        """The ring of segment `s` at `x`'s shape: one eager launch of
        that shape, then RING_SLOTS graphs, each over buffers of its
        own.  The launch counters are put back after the captures."""
        fn = self.segment_fns[s][1]
        x = torch.as_tensor(np.asarray(x))
        with torch.cuda.device(self.device):
            out = fn(to_device(x, self.device))
            torch.cuda.current_stream(self.device).synchronize()
            side = torch.cuda.Stream(self.device)

            def capture():
                slots = []
                for _ in range(RING_SLOTS):
                    host_in = torch.empty(x.shape, dtype=x.dtype,
                                          pin_memory=True)
                    dev_in = torch.empty(x.shape, dtype=x.dtype,
                                         device=self.device)
                    host_out = torch.empty(out.shape, dtype=out.dtype,
                                           pin_memory=True)
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, stream=side,
                                          capture_error_mode="thread_local"):
                        dev_in.copy_(host_in, non_blocking=True)
                        host_out.copy_(fn(dev_in), non_blocking=True)
                    slots.append(_Slot(host_in.numpy(), host_in, dev_in,
                                       host_out, graph, torch.cuda.Event()))
                return slots

            slots, launches = uncounted(capture, RING_SLOTS)
        self.counts.graph_captures += RING_SLOTS
        ring = self._rings[(s, x.shape[0])] = _Ring(slots, launches)
        return ring

    def _replay(self, s: int, x, i: int, observer) -> _Slot:
        """Serve micro-batch `i` of segment `s` from its ring's next
        slot; the result stays in the slot until read."""
        ring = self._rings.get((s, x.shape[0])) or self._capture(s, x)
        slot = ring.take()
        # returns at once where the schedule read the slot's last result;
        # after a failed step it keeps this copy off a replay in flight
        slot.done.synchronize()
        sp = spans.open("pipeline.stage", i, s) if spans.on else None
        np.copyto(slot.x, x, casting="no")
        if sp is not None:
            spans.close(sp)
        t0 = time.perf_counter() if observer is not None else 0.0
        sp = spans.open("pipeline.launch", i, s) if spans.on else None
        slot.graph.replay()
        slot.done.record(torch.cuda.current_stream(self.device))
        for kernel, n in ring.launches:
            kernel.launches += n
        self.counts.graph_replays += 1
        if sp is not None:
            spans.close(sp)
        if observer is not None:
            slot.done.synchronize()
            observer(s, self.segment_fns[s][0], time.perf_counter() - t0,
                     x.shape[0])
        return slot

    # -- serial reference: one micro-batch at a time, Python thread
    #    blocks at every segment boundary (no overlap) ---------------
    def run_serial(self, x_words):
        x = torch.as_tensor(np.asarray(x_words))
        for seg, fn in self.segment_fns:
            if seg.on_device:
                x = fn(to_device(x, self.device)).cpu()  # D2H syncs
            else:
                x = fn(x)
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
        for latency measurement (for a last segment served by a graph,
        once the next micro-batch's replay is queued).  Returns outputs
        (NumPy) in input order, each an array of its own.
        """
        segs = self.segment_fns
        k, n = len(segs), len(inputs)
        if n == 0:
            return []
        graphed = [self._graphed(s) for s in range(k)]
        upload = segs[0][0].on_device and not graphed[0]
        state: list = [None] * n
        staged: list = [None] * n
        outputs: list = [None] * n
        late: list = []             # results left in ring slots

        def stage(i):
            # double-buffered H2D: the upload is queued a wave before
            # micro-batch i first executes (a ring slot's copy waits for
            # its replay: the slot may still hold an unread result)
            if graphed[0]:
                staged[i] = inputs[i]
                return
            sp = spans.open("pipeline.stage", i) if spans.on else None
            x = torch.as_tensor(np.asarray(inputs[i]))
            staged[i] = to_device(x, self.device) if upload else x
            if sp is not None:
                spans.close(sp)

        def finish(i):
            outputs[i] = self._on_host(state[i], i, output=True).numpy()
            state[i] = None
            if on_complete is not None:
                on_complete(i, outputs[i])

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
                if graphed[s]:
                    state[i] = self._replay(s, x, i, observer)
                    continue
                self.counts.eager_device_segments += 1
                if x.device != self.device:
                    sp = (spans.open("pipeline.stage", i, s) if spans.on
                          else None)
                    x = to_device(x, self.device)
                    if sp is not None:
                        spans.close(sp)
                t0 = time.perf_counter() if observer is not None else 0.0
                sp = spans.open("pipeline.launch", i, s) if spans.on else None
                out = fn(x)
                if sp is not None:
                    spans.close(sp)
                if observer is not None:
                    self._wait_for_segment()
                    observer(s, seg, time.perf_counter() - t0, x.shape[0])
                sp = spans.open("pipeline.download", i) if spans.on else None
                state[i] = self._download(out)
                if sp is not None:
                    spans.close(sp)
            # the last wave's replays are queued: read what they follow
            for i in late:
                finish(i)
            late.clear()
            # host advances: reading a device result waits for its D2H
            for i, s in active:
                seg, fn = segs[s]
                if seg.on_device:
                    continue
                x = staged[i] if s == 0 else state[i]
                staged[i] = None
                # an observer's timing includes the wait for the upstream
                # D2H — the host stage pays it un-observed too
                t0 = time.perf_counter() if observer is not None else 0.0
                xh = self._on_host(x, i)
                sp = spans.open("pipeline.host", i, s) if spans.on else None
                state[i] = fn(xh)
                if sp is not None:
                    spans.close(sp)
                if observer is not None:
                    observer(s, seg, time.perf_counter() - t0, xh.shape[0])
            # completions: micro-batch i leaves the pipeline
            for i, s in active:
                if s == k - 1:
                    if graphed[s]:
                        late.append(i)
                    else:
                        finish(i)
        for i in late:
            finish(i)
        return outputs
