"""The serving front end: micro-batching + segment pipelining behind
``submit()`` / ``step()``.

    engine = ServingEngine(model, packed, ec,
                           allowed_batch_sizes=table.batch_sizes)
    reqs = [engine.submit(x_words_one_example) for x in traffic]
    engine.step(force=True)          # or step() in a poll loop
    scores = [r.wait() for r in reqs]

``step()`` drains every ready micro-batch from the batcher and runs
them *together* through the segment pipeline, so a burst of traffic is
where the pipelining pays: the host segments of one micro-batch
overlap the device segments of the previous one.  Each request is
completed (result + latency timestamp) the moment the pipeline reads
its micro-batch's output on the host (one replay later where a graph
serves the last segment), not when the whole wave-train finishes.
``step(force=True)`` on an idle engine (empty queue) is a no-op:
nothing is padded, nothing runs, pending swaps still apply.

**Hot swap.**  :meth:`swap_configuration` replaces the served
``EfficientConfiguration`` (and its segment pipeline) *atomically at a
batch boundary*: a swap requested while a step is executing — e.g.
from a completion callback — is deferred and applied after the
in-flight wave-train retires, so no micro-batch ever sees two
configurations.  The new pipeline is built *before* the old one is
released; a failed build leaves the engine serving the old mapping.
The adaptive loop around this primitive (telemetry -> drift ->
corrected table -> re-mapped configuration) lives in
``repro_torch.adapt``.

**Counters and spans.**  Besides ``served``, ``steps`` and ``swaps``
the engine counts ``microbatches``, their ``real_rows`` and
``pad_rows``, and ``empty_steps`` (steps that found nothing ready);
``graph_counts`` (:class:`~repro_torch.serving.pipeline.GraphCounts`)
adds up, over every pipeline the engine builds, the graphs captured,
their replays and the device segments run eagerly.
With :mod:`repro_torch.spans` recording, a non-empty step is an
``engine.step`` span (micro-batches, real rows) holding the batcher's
``batcher.drain`` spans, the pipeline's spans and one
``engine.complete`` span per micro-batch (micro-batch, rows).

**Threading contract.**  ``submit()`` is thread-safe — any number of
client threads may enqueue concurrently (the ``MicroBatcher`` queue is
lock-protected and FIFO by submission order), and ``Request.wait()``
blocks safely on any thread.  ``step()`` / ``swap_configuration()``
are **not** reentrant: drive them from a single dispatch thread.
"""

from __future__ import annotations

import time
from typing import Sequence

from repro_torch import spans
from repro_torch.bnn.models import BNNModel
from repro_torch.core.mapper import EfficientConfiguration
from repro_torch.device import resolve_device
from repro_torch.serving.batcher import MicroBatcher, Request
from repro_torch.serving.pipeline import GraphCounts, SegmentPipeline


def _tee(always, sampled):
    """Compose the always-on observer with a (possibly absent)
    sampled telemetry observer into one pipeline callback."""
    if sampled is None:
        return always

    def observe(seg_index, segment, seconds, batch):
        always(seg_index, segment, seconds, batch)
        sampled(seg_index, segment, seconds, batch)

    return observe


class ServingEngine:
    def __init__(
        self,
        model: BNNModel,
        packed_params: list,
        config: EfficientConfiguration,
        *,
        max_batch: int | None = None,
        max_wait_s: float = 2e-3,
        allowed_batch_sizes: Sequence[int] | None = None,
        clock=time.monotonic,
        device=None,
        telemetry=None,
        observer=None,
    ):
        """``max_batch`` defaults to the mapper's proper batch size —
        the batch the configuration was optimized for.  Pass the
        ProfileTable's ``batch_sizes`` as ``allowed_batch_sizes`` so
        partial batches pad to a profiled size.  Device segments run on
        `device` (``None`` -> ``cuda``).  ``telemetry``
        (``repro_torch.adapt.SegmentTelemetry``) records per-segment
        wall times on its sampled steps; ``None`` serves
        un-instrumented.  ``observer`` is an *always-on* segment
        observer fired on every step (composed with the sampled
        telemetry observer when both are present).  An observer makes
        the pipelined driver wait for each device segment's own output
        to read its true wall time, so observation trades that wave's
        host/device overlap for the measurement (see
        ``repro_torch.serving.pipeline``)."""
        if max_batch is None:
            max_batch = config.proper_batch_size
        if allowed_batch_sizes is None:
            allowed_batch_sizes = (max_batch,)
        self.model = model
        self.packed_params = packed_params
        self.config = config
        self._device = resolve_device(device)
        self.graph_counts = GraphCounts()   # every pipeline adds to it
        self.pipeline = self._build_pipeline(config)
        self.batcher = MicroBatcher(
            max_batch=max_batch,
            max_wait_s=max_wait_s,
            allowed_batch_sizes=allowed_batch_sizes,
            clock=clock,
        )
        self._clock = clock
        self.telemetry = telemetry
        self.observer = observer
        self.served = 0
        self.steps = 0               # non-empty steps (batch boundaries)
        self.swaps = 0
        self.empty_steps = 0
        self.microbatches = 0
        self.real_rows = 0
        self.pad_rows = 0            # zero rows padding micro-batches
        self._in_step = False
        self._pending_swap: EfficientConfiguration | None = None

    def _build_pipeline(self, config: EfficientConfiguration):
        """The segment pipeline serving `config` on this engine's device.
        Subclass seam: a caller may wrap the returned pipeline's segment
        callables, e.g. to inject synthetic contention into them."""
        return SegmentPipeline(
            self.model, self.packed_params, config, device=self._device,
            counts=self.graph_counts,
        )

    def submit(self, x_words_one) -> Request:
        """Enqueue one example (packed words, no batch dim)."""
        return self.batcher.submit(x_words_one)

    # -- configuration hot swap -------------------------------------
    def swap_configuration(self, config: EfficientConfiguration) -> bool:
        """Serve `config` from the next batch boundary on.

        Returns True when the swap applied immediately (engine idle
        between steps) and False when it was deferred to the end of the
        step currently executing — either way, every request completes
        under exactly one configuration.  Only the last swap requested
        during a step wins (remaps supersede each other).

        Swaps must keep the serving batch size: the batcher's
        coalescing/padding targets were sized for it, and a
        configuration priced at another batch would be served (and
        drift-checked) at a batch the mapper never chose.  Re-batching
        is an engine rebuild, not a swap."""
        if config.proper_batch_size != self.config.proper_batch_size:
            raise ValueError(
                f"hot swap must preserve the serving batch size "
                f"(engine serves {self.config.proper_batch_size}, new "
                f"configuration is for {config.proper_batch_size}); "
                "build a new engine to change batch size"
            )
        if self._in_step:
            self._pending_swap = config
            return False
        self._apply_swap(config)
        return True

    def _apply_swap(self, config: EfficientConfiguration) -> None:
        # reprice-only swaps (same mapping, corrected expectations)
        # keep the pipeline: its callables depend only on layer_configs
        # and the fused-segment selections, and a rebuild re-copies
        # every weight to its placement
        if (
            config.layer_configs != self.config.layer_configs
            or getattr(config, "fused_segments", ())
            != getattr(self.config, "fused_segments", ())
        ):
            # build first, publish second: a failed build
            # (unregistered variant, bad mapping) must leave the old
            # config serving
            self.pipeline = self._build_pipeline(config)
        self.config = config
        self.swaps += 1

    def step(self, *, force: bool = False) -> int:
        """Drain ready micro-batches (all pending ones when ``force``)
        and execute them pipelined.  Returns requests completed.

        An empty queue is a no-op even under ``force`` — the batcher
        never fabricates a zero batch to pad-and-run — and a pending
        swap still applies."""
        sp = spans.open("engine.step") if spans.on else None
        batches, done = (), 0
        try:
            batches = self.batcher.drain(force=force)
            if not batches:
                self.empty_steps += 1
                if sp is not None:
                    spans.discard(sp)
                    sp = None
                self._drain_pending_swap()
                return 0
            padded = 0
            for mb in batches:
                done += mb.n_real
                padded += mb.padded_size
            self.microbatches += len(batches)
            self.real_rows += done
            self.pad_rows += padded - done

            def complete(i, out):
                mb = batches[i]
                cp = (spans.open("engine.complete", i, mb.n_real)
                      if spans.on else None)
                now = self._clock()
                for j, req in enumerate(mb.requests):
                    req.complete(out[j], now)  # pad rows out[n_real:] dropped
                if cp is not None:
                    spans.close(cp)

            observer = None
            if self.telemetry is not None:
                observer = self.telemetry.sample()
            if self.observer is not None:
                observer = _tee(self.observer, observer)
            self._in_step = True
            try:
                self.pipeline.run_pipelined(
                    [mb.x for mb in batches],
                    on_complete=complete,
                    observer=observer,
                )
            except BaseException as e:
                # requests already popped off the queue must not be
                # lost: fail every not-yet-completed one so waiters see
                # the error.  A pending swap stays pending (applied at
                # the next batch boundary) — applying it here could
                # raise a build error that masks the serving failure
                # being diagnosed
                now = self._clock()
                for mb in batches:
                    for req in mb.requests:
                        if req.done_t is None:
                            req.fail(e, now)
                raise
            finally:
                self._in_step = False
            self.served += done
            self.steps += 1
            # the batch boundary: a swap requested mid-step lands here,
            # after the step's work is fully accounted — a failed
            # pipeline build raises from step() but never corrupts
            # served/steps
            self._drain_pending_swap()
            return done
        finally:
            # however the step ends, so that no later span on this
            # thread takes a dead step for its parent
            if sp is not None:
                spans.close(sp, len(batches), done)

    def _drain_pending_swap(self) -> None:
        if self._pending_swap is not None:
            config, self._pending_swap = self._pending_swap, None
            self._apply_swap(config)
