"""The port's serving runtime on CPU tensors: the engine's answers equal
the JAX package's ``forward_packed``, pipelined output equals serial,
the batcher keeps FIFO order with no loss under concurrent submitters,
and configuration swaps land only at batch boundaries."""

from __future__ import annotations

import dataclasses
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import fixtures  # noqa: E402

from repro.bnn import models as R_M  # noqa: E402
from repro_torch.bnn import models as T_M  # noqa: E402
from repro_torch.core.mapper import price_mapping  # noqa: E402
from repro_torch.core.profiler import ProfileTable  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    MicroBatcher,
    SegmentPipeline,
    ServingEngine,
    canonical_mixed_mapping,
    pad_to,
)

BATCH = 2
N_EXAMPLES = 5


_SETUP = {}


def _setup(arch):
    """Port model + params, NumPy packed inputs, and the JAX package's
    forward_packed of them (computed once per architecture)."""
    if arch not in _SETUP:
        r = R_M.build_model(arch, scale=0.25)
        fp = T_M.random_fp_params(r.specs, 5)
        x01 = np.random.default_rng(6).random(
            (N_EXAMPLES, *r.input_hw, r.in_channels), dtype=np.float32)
        xw = R_M.prepare_input_packed(jnp.asarray(x01))
        want = np.asarray(R_M.forward_packed(
            r.specs, R_M.pack_params(r.specs, fp), xw))
        m = T_M.build_model(arch, scale=0.25)
        packed = T_M.pack_params(m.specs, fp, device="cpu")
        table = ProfileTable.from_json(
            fixtures.flat_table(r, batch=BATCH).to_json())
        _SETUP[arch] = (m, packed, np.array(xw), want, table)
    return _SETUP[arch]


def _config(arch, kind):
    m, packed, _, _, table = _setup(arch)
    n = len(m.specs)
    if kind == "mixed":
        return price_mapping(table, BATCH, canonical_mixed_mapping(m))
    ec = price_mapping(table, BATCH, ("CPU",) + ("XYZ",) * (n - 1))
    if kind == "fused":
        ec = dataclasses.replace(ec, fused_segments=((1, n, "seg_cuda", 1e-9),))
    return ec


@pytest.mark.parametrize("arch", ["cifar10", "fashion_mnist"])
@pytest.mark.parametrize("kind", ["mixed", "device", "fused"])
def test_engine_serves_bit_exact_vs_reference(arch, kind):
    m, packed, xw, want, table = _setup(arch)
    engine = ServingEngine(m, packed, _config(arch, kind),
                           allowed_batch_sizes=table.batch_sizes,
                           device="cpu")
    reqs = [engine.submit(xw[i]) for i in range(N_EXAMPLES)]
    assert engine.step(force=True) == N_EXAMPLES
    got = np.stack([r.wait(timeout=60) for r in reqs])
    assert np.array_equal(got, want)
    assert all(r.latency_s >= 0 for r in reqs)
    assert engine.served == N_EXAMPLES and engine.steps == 1


@pytest.mark.parametrize("kind", ["mixed", "fused"])
def test_pipelined_equals_serial(kind):
    m, packed, xw, want, _ = _setup("cifar10")
    pipe = SegmentPipeline(m, packed, _config("cifar10", kind), device="cpu")
    batches = [xw[0:2], xw[2:4], xw[4:5]]
    done = []
    seen = []
    outs = pipe.run_pipelined(
        batches, on_complete=lambda i, out: done.append(i),
        observer=lambda s, seg, t, b: seen.append((s, b)))
    assert done == [0, 1, 2]
    serial = [pipe.run_serial(b) for b in batches]
    for o, s_ in zip(outs, serial):
        assert np.array_equal(o, s_)
    assert np.array_equal(np.concatenate(outs), want)
    n_seg = len(pipe.segments)
    assert len(seen) == n_seg * len(batches)
    assert sorted(b for _, b in seen) == sorted([2, 2, 1] * n_seg)
    assert pipe.run_pipelined([]) == []


def test_pipeline_refuses_non_segment_plans():
    from repro_torch.core.plan import build_plan

    m, packed, _, _, _ = _setup("fashion_mnist")
    ec = _config("fashion_mnist", "mixed")
    with pytest.raises(ValueError, match="segments"):
        SegmentPipeline(m, packed, ec, plan=build_plan(ec, mode="layers"),
                        device="cpu")


def test_concurrent_submitters_are_served_exactly():
    m, packed, xw, want, table = _setup("fashion_mnist")
    engine = ServingEngine(m, packed, _config("fashion_mnist", "mixed"),
                           allowed_batch_sizes=table.batch_sizes,
                           device="cpu")
    reqs = [None] * N_EXAMPLES

    def client(i):
        reqs[i] = engine.submit(xw[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(N_EXAMPLES)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    engine.step(force=True)
    assert np.array_equal(np.stack([r.wait(timeout=60) for r in reqs]), want)


def test_batcher_fifo_no_loss_under_8_threads():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        batcher = MicroBatcher(max_batch=4, allowed_batch_sizes=(1, 2, 4))
        per_thread = 50

        def client(k):
            for j in range(per_thread):
                batcher.submit(np.array([k, j], np.int32))

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    got = [r for mb in batcher.drain(force=True) for r in mb.requests]
    assert len(got) == 8 * per_thread
    assert [r.submit_t for r in got] == sorted(r.submit_t for r in got)
    for k in range(8):
        assert [int(r.x[1]) for r in got if r.x[0] == k] == list(
            range(per_thread))


def test_batcher_deadlines_and_padding():
    clock = fixtures.FakeClock()
    b = MicroBatcher(max_batch=4, max_wait_s=1.0,
                     allowed_batch_sizes=(1, 4), clock=clock)
    assert b.next_batch() is None
    b.submit(np.ones(3, np.int32))
    b.submit(np.ones(3, np.int32))
    assert not b.ready()
    clock.advance(1.0)
    mb = b.next_batch()
    assert mb.n_real == 2 and mb.padded_size == 4
    assert not mb.x[2:].any()
    assert pad_to(3, (1, 4, 16)) == 4 and pad_to(3, None) == 3
    for bad in ((0, (1,)), (5, (1, 4)), (1, ())):
        with pytest.raises(ValueError):
            pad_to(*bad)
    with pytest.raises(ValueError):
        MicroBatcher(max_batch=8, allowed_batch_sizes=(1, 4))


def test_idle_step_is_a_noop_and_applies_pending_swap():
    m, packed, _, _, table = _setup("fashion_mnist")
    engine = ServingEngine(m, packed, _config("fashion_mnist", "mixed"),
                           allowed_batch_sizes=table.batch_sizes,
                           device="cpu")
    assert engine.step(force=True) == 0 and engine.steps == 0
    new = _config("fashion_mnist", "device")
    engine._pending_swap = new
    engine.step(force=True)
    assert engine.config is new and engine.swaps == 1


def test_swap_requested_mid_step_lands_at_the_batch_boundary():
    m, packed, xw, want, table = _setup("cifar10")
    first = _config("cifar10", "mixed")
    second = _config("cifar10", "fused")
    engine = ServingEngine(m, packed, first, max_batch=BATCH,
                           allowed_batch_sizes=table.batch_sizes,
                           device="cpu")
    applied = []
    old_pipeline = engine.pipeline
    pipeline_run = old_pipeline.run_pipelined

    def run(inputs, *, on_complete, observer=None):
        def complete(i, out):
            if i == 0:
                applied.append(engine.swap_configuration(second))
            assert engine.config is first     # never mid wave-train
            on_complete(i, out)
        return pipeline_run(inputs, on_complete=complete, observer=observer)

    old_pipeline.run_pipelined = run
    reqs = [engine.submit(xw[i]) for i in range(N_EXAMPLES)]
    engine.step(force=True)
    assert applied == [False]
    assert engine.config is second and engine.pipeline is not old_pipeline
    assert np.array_equal(np.stack([r.wait() for r in reqs]), want)
    reqs = [engine.submit(xw[i]) for i in range(N_EXAMPLES)]
    engine.step(force=True)
    assert np.array_equal(np.stack([r.wait() for r in reqs]), want)


def test_swap_rules():
    m, packed, _, _, table = _setup("fashion_mnist")
    ec = _config("fashion_mnist", "device")
    engine = ServingEngine(m, packed, ec, allowed_batch_sizes=(1, 2, 4),
                           device="cpu")
    pipeline = engine.pipeline
    repriced = dataclasses.replace(ec, expected_time_per_example=1.0)
    assert engine.swap_configuration(repriced) is True
    assert engine.pipeline is pipeline          # reprice-only: no rebuild
    with pytest.raises(ValueError, match="batch size"):
        engine.swap_configuration(dataclasses.replace(ec, proper_batch_size=4))
    bad = dataclasses.replace(
        ec, fused_segments=((1, len(m.specs), "XYZ", 1e-9),))
    with pytest.raises(ValueError, match="scope"):
        engine.swap_configuration(bad)
    assert engine.config is repriced and engine.pipeline is pipeline


def test_failed_pipeline_fails_every_popped_request():
    m, packed, xw, _, table = _setup("fashion_mnist")
    engine = ServingEngine(m, packed, _config("fashion_mnist", "mixed"),
                           allowed_batch_sizes=table.batch_sizes,
                           device="cpu")

    def boom(*a, **k):
        raise RuntimeError("device lost")

    engine.pipeline.run_pipelined = boom
    reqs = [engine.submit(xw[i]) for i in range(3)]
    with pytest.raises(RuntimeError, match="device lost"):
        engine.step(force=True)
    for r in reqs:
        with pytest.raises(RuntimeError, match="device lost"):
            r.wait(timeout=1)


# -- when the graph path engages: never on a CPU, never for a callable
#    wrapped after the build or an unfused device segment ----------------


class _WrappedEngine(ServingEngine):
    """Wraps each device segment's callable through the build seam, as
    a contention-injecting engine does."""

    def _build_pipeline(self, config):
        pipe = super()._build_pipeline(config)

        def wrap(fn):
            return lambda x: fn(x)

        pipe.segment_fns = [(seg, wrap(fn) if seg.on_device else fn)
                            for seg, fn in pipe.segment_fns]
        return pipe


@pytest.mark.parametrize("case", ["cpu", "wrapped", "unfused"])
def test_device_segments_run_eagerly_where_no_graph_engages(case):
    """Each case serves eagerly on the CPU and counts every (micro-batch,
    device segment) as eager; with the pipeline's device relabelled
    ``cuda`` only the fused node with its built callable would take
    the graph path."""
    m, packed, xw, want, table = _setup("cifar10")
    kind = "device" if case == "unfused" else "fused"
    cls = _WrappedEngine if case == "wrapped" else ServingEngine
    engine = cls(m, packed, _config("cifar10", kind),
                 allowed_batch_sizes=table.batch_sizes, device="cpu")
    reqs = [engine.submit(xw[i]) for i in range(N_EXAMPLES)]
    assert engine.step(force=True) == N_EXAMPLES
    assert np.array_equal(np.stack([r.wait(timeout=60) for r in reqs]), want)
    pipe = engine.pipeline
    n_device = sum(seg.on_device for seg in pipe.segments)
    counts = engine.graph_counts
    assert (counts.graph_captures, counts.graph_replays) == (0, 0)
    assert counts.eager_device_segments == engine.microbatches * n_device
    assert not any(pipe._graphed(s) for s in range(len(pipe.segments)))
    pipe.device = torch.device("cuda", 0)      # the label only: no launch
    assert [pipe._graphed(s) for s in range(len(pipe.segments))] == [
        seg.on_device and case == "cpu" for seg in pipe.segments]


def test_graph_counters_are_in_deployment_stats_and_survive_swaps():
    from repro_torch import api

    m, packed, xw, want, table = _setup("cifar10")
    dep = api.Deployment.plan((m, packed), batch_sizes=(BATCH,),
                              time_source="analytic", repeats=1,
                              device="cpu").serve(max_batch=BATCH)
    reqs = [dep.submit(xw[i]) for i in range(N_EXAMPLES)]
    assert dep.drain() == N_EXAMPLES
    assert np.array_equal(np.stack([r.wait(timeout=60) for r in reqs]), want)
    engine = dep.engine
    n_device = sum(seg.on_device for seg in engine.pipeline.segments)
    s = dep.stats()
    assert (s["graph_captures"], s["graph_replays"]) == (0, 0)
    assert s["eager_device_segments"] == s["microbatches"] * n_device
    # a swap builds a new pipeline that adds to the same counters
    pipeline = engine.pipeline
    assert engine.swap_configuration(_config("cifar10", "mixed"))
    assert engine.pipeline is not pipeline
    assert engine.pipeline.counts is engine.graph_counts
    reqs = [dep.submit(xw[i]) for i in range(BATCH)]
    assert dep.drain() == BATCH
    n_mixed = sum(seg.on_device for seg in engine.pipeline.segments)
    assert dep.stats()["eager_device_segments"] == (
        s["eager_device_segments"] + n_mixed)


@pytest.mark.parametrize("kind", ["mixed", "fused"])
def test_results_of_successive_microbatches_share_no_memory(kind):
    m, packed, xw, want, table = _setup("cifar10")
    engine = ServingEngine(m, packed, _config("cifar10", kind),
                           allowed_batch_sizes=table.batch_sizes,
                           device="cpu")
    kept = []
    for _ in range(3):
        reqs = [engine.submit(xw[i]) for i in range(N_EXAMPLES)]
        engine.step(force=True)
        kept += [r.wait(timeout=60) for r in reqs]
    assert np.array_equal(np.stack(kept[:N_EXAMPLES]), want)
    for a in range(len(kept)):
        for b in range(a + 1, len(kept)):
            assert not np.shares_memory(kept[a], kept[b])


class _FakeEvent:
    def __init__(self):
        self.waited = True

    def record(self, stream=None):
        self.waited = False

    def synchronize(self):
        self.waited = True


class _RingOnCPU(SegmentPipeline):
    """The graph path's schedule on CPU tensors: a fused device segment
    "replays" by running its callable into the next of two slots, and
    refuses to overwrite a slot whose result was never waited on."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.log = []

    def _graphed(self, s):
        node, _ = self.segment_fns[s]
        return node.on_device and node.fused_variant is not None

    def _replay(self, s, x, i, observer):
        from repro_torch.serving import pipeline as P

        ring = self._rings.setdefault(s, P._Ring(
            [P._Slot(None, None, None, None, None, _FakeEvent())
             for _ in range(P.RING_SLOTS)], []))
        slot = ring.take()
        assert slot.done.waited, f"micro-batch {i} overwrites an unread slot"
        out = self.segment_fns[s][1](torch.as_tensor(np.asarray(x)))
        if slot.host_out is None or slot.host_out.shape != out.shape:
            slot.host_out = torch.empty_like(out)
        slot.host_out.copy_(out)
        slot.done.record()
        self.counts.graph_replays += 1
        self.log.append(("replay", i))
        return slot


@pytest.mark.parametrize("kind", ["fused", "mixed_fused"])
def test_ring_schedule_reads_each_slot_after_the_next_replay(kind):
    """Results left in ring slots are read, and copied out, only after
    the next micro-batch's replay is queued, never after their slot is
    reused; answers equal the serial driver's, in order."""
    m, packed, xw, want, table = _setup("cifar10")
    n = len(m.specs)
    ec = _config("cifar10", "fused")            # host -> fused device
    if kind == "mixed_fused":                   # ... -> host
        ec = dataclasses.replace(
            price_mapping(table, BATCH, ("CPU",) + ("XYZ",) * (n - 2)
                          + ("CPU",)),
            fused_segments=((1, n - 1, "seg_cuda", 1e-9),))
    pipe = _RingOnCPU(m, packed, ec, device="cpu")
    assert [pipe._graphed(s) for s in range(len(pipe.segments))] == (
        [False, True] if kind == "fused" else [False, True, False])
    batches = [xw[j % N_EXAMPLES:j % N_EXAMPLES + 1] for j in range(6)]
    outs = pipe.run_pipelined(
        batches, on_complete=lambda i, out: pipe.log.append(("done", i)))
    for o, b in zip(outs, batches):
        assert np.array_equal(o, pipe.run_serial(b))
    done = [i for what, i in pipe.log if what == "done"]
    assert done == list(range(6))
    last = len(pipe.segments) - 1
    for i in range(5):
        if pipe._graphed(last):
            assert pipe.log.index(("done", i)) > pipe.log.index(
                ("replay", i + 1))
    assert pipe.counts.graph_replays == 6
    assert pipe.counts.eager_device_segments == 0
    slots = [sl for ring in pipe._rings.values() for sl in ring.slots]
    for o in outs:
        assert not any(np.shares_memory(o, sl.host_out.numpy())
                       for sl in slots)
