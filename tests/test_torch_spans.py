"""The port's span recorder (``repro_torch.spans``) on CPU tensors: the
span tree a serving step records, the engine's row counters against
its drain spans, answers unchanged by recording, the ``gc`` spans, the
planning span, a failed step's span, the build's ``nvcc`` count, and
the recorder's own bookkeeping (parents per thread, children an
exception left open, discarded spans)."""

from __future__ import annotations

import dataclasses
import gc
import os
import stat
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.bnn.models import (  # noqa: E402
    build_model,
    pack_params,
    prepare_input_packed,
    random_fp_params,
)
from repro_torch.core.mapper import price_mapping  # noqa: E402
from repro_torch.core.parallel_config import CONFIGS  # noqa: E402
from repro_torch.core.profiler import ProfileTable  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ServingEngine,
    canonical_mixed_mapping,
)
from repro_torch.serving.batcher import pad_to  # noqa: E402

N_REQ = 9              # 4 + 4 + 1: three micro-batches, the last padded


@pytest.fixture
def no_auto_gc():
    """No collection but the test's own, so no stray ``gc`` span."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.stop()
    spans.take()
    yield
    spans.stop()
    spans.take()


_S: dict = {}


def _setup():
    """(model, packed, the canonical mixed configuration at batch 4,
    N_REQ packed images)."""
    if not _S:
        m = build_model("fashion_mnist", scale=0.25)
        packed = pack_params(m.specs, random_fp_params(m.specs, 0),
                             device="cpu")
        n = len(m.specs)
        row = [{c: 1e-4 for c in CONFIGS} for _ in range(n)]
        table = ProfileTable(
            m.name, (4,), tuple(f"L{s.idx}:{s.notation}" for s in m.specs),
            {4: row}, kernel_times={4: row},
            h2d_times={4: [0.0] * n}, d2h_times={4: [0.0] * n},
        )
        ec = price_mapping(table, 4, canonical_mixed_mapping(m))
        x01 = np.random.default_rng(1).integers(
            0, 2, size=(N_REQ, 28, 28, 1)).astype(np.float32)
        xw = prepare_input_packed(torch.as_tensor(x01)).numpy()
        _S["v"] = (m, packed, ec, xw)
    return _S["v"]


def _serve(record: bool):
    """Serve N_REQ requests in one forced step (then one empty step);
    returns (engine, answers, spans taken)."""
    m, packed, ec, xw = _setup()
    engine = ServingEngine(m, packed, ec, allowed_batch_sizes=(2, 4),
                           device="cpu")
    if record:
        spans.start()
    reqs = [engine.submit(xw[i]) for i in range(N_REQ)]
    assert engine.step(force=True) == N_REQ
    assert engine.step() == 0
    spans.stop()
    answers = np.stack([r.wait(timeout=60) for r in reqs])
    return engine, answers, spans.take()


def _named(t, name):
    return np.flatnonzero(t.name == name)


def test_serving_step_records_the_span_tree():
    engine, _, t = _serve(record=True)
    main = threading.get_ident()
    assert set(t.thread.tolist()) == {main}
    assert np.all(t.end >= t.start)
    # the empty step left no span
    (step,) = _named(t, "engine.step")
    assert t.parent[step] == -1 and (t.a[step], t.b[step]) == (3, N_REQ)
    # the client's submits record no span
    assert {"batcher.submit"}.isdisjoint(t.name.tolist())
    drains = _named(t, "batcher.drain")
    # first request id, real rows: consecutive id runs
    assert t.a[drains].tolist() == [0, 4, 8]
    assert t.b[drains].tolist() == [4, 4, 1]
    assert np.all(t.parent[drains] == step)
    segs = engine.pipeline.segments
    device = [s for s, seg in enumerate(segs) if seg.on_device]
    host = [s for s, seg in enumerate(segs) if not seg.on_device]
    assert device and host
    for name, per_mb in [("pipeline.stage", 1),
                         ("pipeline.launch", len(device)),
                         ("pipeline.download", len(device)),
                         ("pipeline.host", len(host)),
                         ("engine.complete", 1)]:
        idx = _named(t, name)
        assert np.all(t.parent[idx] == step), name
        assert sorted(t.a[idx].tolist()) == sorted(
            [0, 1, 2] * per_mb), name
    for name, want in [("pipeline.launch", device), ("pipeline.host", host)]:
        for i in range(3):
            idx = [k for k in _named(t, name) if t.a[k] == i]
            assert t.b[idx].tolist() == want, (name, i)
    completes = _named(t, "engine.complete")
    assert t.b[completes].tolist() == [4, 4, 1]
    # a micro-batch's spans run in pipeline order, inside the step
    for i in range(3):
        order = [t.name[k] for k in np.argsort(t.start, kind="stable")
                 if t.name[k].startswith(("pipeline.", "engine.complete"))
                 and t.a[k] == i and t.name[k] != "pipeline.download"]
        assert order[0] == "pipeline.stage"
        assert order[-1] == "engine.complete"
    inner = t.parent == step
    assert np.all(t.start[inner] >= t.start[step])
    assert np.all(t.end[inner] <= t.end[step])
    # no d2h wait on CPU tensors: it is the card's event
    assert len(_named(t, "pipeline.d2h_wait")) == 0


def test_pending_download_records_its_wait(monkeypatch):
    """The card's path on CPU tensors: each device segment's output goes
    through a pending download whose event the host waits on."""
    from repro_torch.serving import pipeline as P

    class Event:
        def synchronize(self):
            time.sleep(1e-4)

    monkeypatch.setattr(P.SegmentPipeline, "_download",
                        lambda self, out: P._Download(out, Event()))
    engine, answers, t = _serve(record=True)
    _, want, _ = _serve(record=False)
    assert np.array_equal(answers, want)
    (step,) = _named(t, "engine.step")
    waits = _named(t, "pipeline.d2h_wait")
    n_device = sum(seg.on_device for seg in engine.pipeline.segments)
    assert sorted(t.a[waits].tolist()) == sorted([0, 1, 2] * n_device)
    assert np.all(t.parent[waits] == step)
    assert np.all(t.end[waits] - t.start[waits] >= 100_000)


def test_drain_rows_equal_the_engine_counters():
    engine, _, t = _serve(record=True)
    drains = _named(t, "batcher.drain")
    assert engine.microbatches == len(drains) == 3
    assert engine.real_rows == int(t.b[drains].sum()) == N_REQ
    # padded rows follow from the real ones and the allowed sizes
    padded = [pad_to(int(b), engine.batcher.allowed_batch_sizes)
              for b in t.b[drains]]
    assert engine.pad_rows == sum(padded) - N_REQ == 1
    assert engine.empty_steps == 1
    assert engine.steps == 1 and engine.served == N_REQ


def test_recording_off_records_nothing_and_changes_no_answer():
    off_engine, off, t_off = _serve(record=False)
    assert len(t_off) == 0
    _, on, t_on = _serve(record=True)
    assert len(t_on) > 0
    assert np.array_equal(off, on)
    # the counters count with recording off too
    assert (off_engine.microbatches, off_engine.real_rows,
            off_engine.pad_rows) == (3, N_REQ, 1)


def test_gc_span_only_while_recording(no_auto_gc):
    spans.start()
    assert spans._on_gc in gc.callbacks
    gc.collect()
    spans.stop()
    assert spans._on_gc not in gc.callbacks
    t = spans.take()
    (k,) = _named(t, "gc")
    assert t.a[k] == 2 and t.end[k] >= t.start[k]
    gc.collect()
    assert len(spans.take()) == 0


def test_parents_per_thread_and_left_open_children(no_auto_gc):
    spans.start()
    before = time.monotonic_ns()
    outer = spans.open("outer", 1)
    inner = spans.open("inner", 2)
    other = []

    def work():
        sp = spans.open("other")
        other.append(threading.get_ident())
        spans.close(sp, 7)

    th = threading.Thread(target=work)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    # an exception skipped inner's close: closing outer unstacks it
    spans.close(outer, b=5)
    after = spans.open("after")
    spans.close(after)
    gone = spans.open("gone")
    spans.discard(gone)
    spans.stop()
    t = spans.take()
    assert t.name.tolist() == ["outer", "inner", "other", "after"]
    assert t.parent.tolist() == [-1, 0, -1, -1]
    assert (t.a[0], t.b[0], t.a[1], t.a[2]) == (1, 5, 2, 7)
    assert t.end[1] == -1                 # never closed
    assert t.thread[2] == other[0] != t.thread[0]
    assert np.all(t.start >= before)
    assert np.all(t.end[[0, 2, 3]] >= t.start[[0, 2, 3]])
    assert np.all(t.end[[0, 2, 3]] <= time.monotonic_ns())
    spans.close(inner)                    # after the take: harmless
    assert len(spans.take()) == 0


@pytest.mark.parametrize("fuse", [False, True])
def test_plan_records_only_the_fuse_span(tmp_path, fuse, monkeypatch):
    from repro_torch import api

    m, packed, _, _ = _setup()
    if fuse:      # the re-measure itself is tested with the mapper
        monkeypatch.setattr(api, "fuse_mapping",
                            lambda *a, **k: a[3])
    spans.start()
    api.plan_single(m, packed, batch_sizes=(4,), store=f"dir://{tmp_path}",
                    time_source="analytic", repeats=1, device="cpu",
                    fuse=fuse)
    spans.stop()
    t = spans.take()
    assert set(t.name.tolist()) <= {"plan.fuse", "gc"}
    assert len(_named(t, "plan.fuse")) == int(fuse)


def test_kernel_build_counts_nvcc_runs(tmp_path, monkeypatch):
    from repro_torch.kernels import build

    csrc, out = tmp_path / "csrc", tmp_path / "out"
    csrc.mkdir()
    (csrc / "probe.cu").write_text("// a source\n")
    nvcc = tmp_path / "nvcc"
    # writes the file after -o, as nvcc would
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    before = build.compiles
    targets = build.build_all()
    build.build_all()                     # up to date: no nvcc run
    assert os.path.exists(targets["probe"])
    assert build.compiles == before + 1


@pytest.mark.parametrize("busy", [True, False])
def test_a_step_whose_swap_build_fails_leaves_no_open_parent(
        busy, monkeypatch):
    """A pending swap whose pipeline build raises at the batch boundary
    (after a served step, or in an empty one): the step's span is still
    closed or dropped, and the next step's span is a root."""
    m, packed, ec, xw = _setup()
    engine = ServingEngine(m, packed, ec, allowed_batch_sizes=(2, 4),
                           device="cpu")

    def fail(config):
        raise RuntimeError("build failed")

    monkeypatch.setattr(engine, "_build_pipeline", fail)
    engine._pending_swap = dataclasses.replace(
        ec, layer_configs=("XYZ",) * len(ec.layer_configs),
        fused_segments=(("probe",),))
    spans.start()
    n = 4 if busy else 0
    for i in range(n):
        engine.submit(xw[i])
    with pytest.raises(RuntimeError, match="build failed"):
        engine.step(force=True)
    assert engine.served == n and engine.config is ec
    reqs = [engine.submit(xw[i]) for i in range(4)]
    assert engine.step(force=True) == 4
    spans.stop()
    for r in reqs:
        r.wait(timeout=60)
    t = spans.take()
    steps = _named(t, "engine.step")
    assert len(steps) == 1 + busy
    assert np.all(t.parent[steps] == -1)
    assert np.all(t.end[steps] >= t.start[steps])
    assert t.b[steps].tolist() == [4] * (1 + busy)
    assert np.all(t.parent[_named(t, "batcher.drain")] >= 0)


def test_recording_makes_no_tracked_object(no_auto_gc):
    spans.start()
    spans.close(spans.open("warm"))       # this thread's buffer
    before = len(gc.get_objects())
    for i in range(10_000):
        sp = spans.open("outer", i)
        spans.close(spans.open("inner", i))
        spans.close(sp, b=i)
    grew = len(gc.get_objects()) - before
    spans.stop()
    t = spans.take()
    assert len(t) == 20_001
    assert grew < 50
    outer = _named(t, "outer")
    assert np.all(t.parent[_named(t, "inner")] == outer)
    assert t.b[outer].tolist() == list(range(10_000))


def test_concurrent_threads_record_their_own_trees():
    import sys

    n_threads, n_spans = 8, 500
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        spans.start()
        # all alive together: a finished thread's ident may be reused
        together = threading.Barrier(n_threads, timeout=60)

        def work(k):
            together.wait()
            for i in range(n_spans):
                sp = spans.open("outer", k, i)
                spans.close(spans.open("inner", k, i))
                spans.close(sp)
            together.wait()

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        spans.stop()
    finally:
        sys.setswitchinterval(switch)
    t = spans.take()
    inner, outer = _named(t, "inner"), _named(t, "outer")
    assert len(inner) == len(outer) == n_threads * n_spans
    p = t.parent[inner]
    assert np.all(t.name[p] == "outer")
    assert np.all((t.a[p] == t.a[inner]) & (t.b[p] == t.b[inner]))
    assert np.all(t.thread[p] == t.thread[inner])
    assert len(set(t.thread[outer].tolist())) == n_threads
    assert np.all(t.end >= t.start)
