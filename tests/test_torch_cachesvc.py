"""The port's cache service (``repro_torch.cachesvc``) against the JAX
package's: one backend contract suite over the dir / sqlite / mem /
tiered backends of both packages, a ``dir://`` root written by either
package read back in the other, equal ETags and access counts for the
same operations, the deduped / retried / journaled work queue under
virtual time (equal journals), and the job bodies and the service on
the same tables (equal result dicts).  Every test that starts a
``WorkerPool`` or a periodic flush stops it in a ``finally`` with a
join timeout.  Mirrors ``tests/test_cachesvc_backends.py`` and the
cases of ``tests/test_cachesvc.py``, refit passes and the cluster's
warm start from a shared store included."""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from fixtures import (  # noqa: E402
    FakeClock,
    flat_table,
    loglinear_table,
    planted_gamma_ledger,
    synthetic_model,
    tied_table,
)

from repro import cachesvc as R_C  # noqa: E402
from repro import estimator as R_E  # noqa: E402
from repro import store as R_S  # noqa: E402
from repro.bnn import models as R_M  # noqa: E402
from repro.cachesvc import jobs as R_J  # noqa: E402
from repro.cachesvc.backends import validate_key as r_validate_key  # noqa: E402
from repro.core import mapper as R_MAP  # noqa: E402
from repro.core.parallel_config import CONFIGS, CPU  # noqa: E402
from repro.core.profiler import ProfileTable as R_Table  # noqa: E402
from repro.kernels import registry as R_REG  # noqa: E402
from repro_torch import cachesvc as T_C  # noqa: E402
from repro_torch import fleet as T_F  # noqa: E402
from repro_torch import store as T_S  # noqa: E402
from repro_torch.bnn import models as T_M  # noqa: E402
from repro_torch.cachesvc import jobs as T_J  # noqa: E402
from repro_torch.cachesvc.backends import validate_key  # noqa: E402
from repro_torch.core import mapper as T_MAP  # noqa: E402
from repro_torch.core.mapper import DEVICE, HOST, placement_of  # noqa: E402
from repro_torch.core.profiler import ProfileTable  # noqa: E402
from repro_torch.kernels import registry as T_REG  # noqa: E402

PKGS = {"reference": R_C, "port": T_C}
BACKENDS = ("dir", "sqlite", "mem", "tiered")
MODEL = T_M.build_model("fashion_mnist", scale=0.25)
R_MODEL = R_M.build_model("fashion_mnist", scale=0.25)


def make_backend(C, kind, tmp_path, *, policy=None, clock=time.time):
    if kind == "dir":
        return C.LocalDirBackend(tmp_path / "root", policy=policy, clock=clock)
    if kind == "sqlite":
        return C.SqliteBackend(tmp_path / "cache.db", policy=policy,
                               clock=clock)
    if kind == "mem":
        return C.MemoryBackend(policy=policy, clock=clock)
    if kind == "tiered":
        return C.TieredBackend(
            C.MemoryBackend(clock=clock),
            C.SqliteBackend(tmp_path / "back.db", clock=clock),
            policy=policy, clock=clock)
    raise AssertionError(kind)


# ---------------------------------------------------------------------------
# backend contract, both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("kind", BACKENDS)
def test_contract_roundtrip_counters_and_peek(pkg, kind, tmp_path):
    b = make_backend(PKGS[pkg], kind, tmp_path)
    assert b.get("a/x.json") is None
    assert b.misses == 1 and b.hits == 0
    b.put("a/x.json", '{"v": 1}')
    assert b.puts == 1
    assert b.get("a/x.json") == '{"v": 1}' and b.hits == 1
    assert b.peek("a/x.json") == '{"v": 1}'
    assert b.peek("a/missing.json") is None
    assert b.hits == 1 and b.misses == 1
    assert b.access_counts() == {"a/x.json": 1}
    b.get("a/x.json")
    assert b.access_counts() == {"a/x.json": 2}


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("kind", BACKENDS)
def test_contract_overwrite_etag_and_delete(pkg, kind, tmp_path):
    b = make_backend(PKGS[pkg], kind, tmp_path)
    assert b.etag("k.json") is None
    b.put("k.json", "one")
    tag1 = b.etag("k.json")
    assert tag1 and len(tag1) == 12
    b.put("k.json", "one")
    assert b.etag("k.json") == tag1
    b.put("k.json", "two")
    assert b.etag("k.json") != tag1
    assert b.get("k.json") == "two"
    assert b.delete("k.json") is True and b.delete("k.json") is False
    assert b.deletes == 1 and b.get("k.json") is None
    assert b.access_counts() == {}


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("kind", BACKENDS)
def test_contract_list_is_prefix_filtered_and_sorted(pkg, kind, tmp_path):
    b = make_backend(PKGS[pkg], kind, tmp_path)
    for k in ("v1/fp/b/m.json", "v1/fp/a/p.json", "v2/other.json"):
        b.put(k, "{}")
    assert b.list() == ["v1/fp/a/p.json", "v1/fp/b/m.json", "v2/other.json"]
    assert b.list("v1/fp/") == ["v1/fp/a/p.json", "v1/fp/b/m.json"]
    assert b.list("nope/") == []


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("kind", BACKENDS)
def test_contract_stats_shape(pkg, kind, tmp_path):
    b = make_backend(PKGS[pkg], kind, tmp_path)
    b.put("x.json", "1")
    s = b.stats()
    for field in ("backend", "uri", "entries", "hits", "misses", "puts",
                  "deletes", "evictions"):
        assert field in s
    assert s["entries"] == 1 and s["uri"] == b.uri()


@pytest.mark.parametrize("kind", BACKENDS)
def test_same_operations_give_equal_etags_counts_and_stats(kind, tmp_path):
    """One operation sequence on each package's backend: every ETag,
    access count and counter is equal."""
    seen = []
    for pkg, C in PKGS.items():
        b = make_backend(C, kind, tmp_path / pkg)
        log = []
        for op, key, text in (
                ("put", "v1/a/x.json", "alpha"), ("get", "v1/a/x.json", None),
                ("get", "v1/a/y.json", None), ("put", "v1/a/y.json", "beta"),
                ("get", "v1/a/y.json", None), ("get", "v1/a/x.json", None),
                ("put", "v1/a/x.json", "gamma"), ("peek", "v1/a/x.json", None),
                ("delete", "v1/a/y.json", None), ("get", "v1/a/x.json", None)):
            out = b.put(key, text) if op == "put" else getattr(b, op)(key)
            log.append((op, key, out, b.etag(key)))
        stats = {k: v for k, v in b.stats().items()
                 if k not in ("uri", "front", "back")}
        seen.append((log, b.access_counts(), stats, b.list()))
    assert seen[0] == seen[1]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_dir_root_reads_back_in_the_other_package(writer, tmp_path):
    """The dir layout is byte-identical: files one package writes are
    the other's keys, texts and ETags."""
    reader = "port" if writer == "reference" else "reference"
    w = PKGS[writer].LocalDirBackend(tmp_path)
    for k, text in (("v1/fp/m-r1/profile-b1x4.json", '{"a": 1}'),
                    ("v1/fp/s-x/m-r1/mapping-dp-b4.json", '{"b": 2}')):
        w.put(k, text)
    r = PKGS[reader].parse_backend(f"dir://{tmp_path}")
    assert r.list() == w.list()
    for k in w.list():
        assert r.get(k) == w.peek(k) and r.etag(k) == w.etag(k)
        assert r.path_for(k) == w.path_for(k)
    assert sorted(p.relative_to(tmp_path).as_posix()
                  for p in tmp_path.rglob("*") if p.is_file()) == w.list()


@pytest.mark.parametrize("key", [
    "/abs/path.json", "a/../b.json", "./x.json", "a\\b.json",
    "bad\0key.json", "",
])
def test_hostile_keys_rejected_everywhere(key, tmp_path):
    for check in (validate_key, r_validate_key):
        with pytest.raises(ValueError):
            check(key)
    b = make_backend(T_C, "dir", tmp_path)
    for op in (b.get, b.peek, b.etag, b.delete):
        with pytest.raises(ValueError):
            op(key)
    with pytest.raises(ValueError):
        b.put(key, "x")


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("kind", ("dir", "sqlite", "mem"))
def test_lru_eviction_keeps_recently_accessed(pkg, kind, tmp_path):
    clock = FakeClock()
    clock.t = time.time() + 3600.0
    C = PKGS[pkg]
    b = make_backend(C, kind, tmp_path,
                     policy=C.EvictionPolicy(max_entries=2), clock=clock)
    b.put("a.json", "A")
    clock.advance(1.0)
    b.put("b.json", "B")
    clock.advance(1.0)
    assert b.get("a.json") == "A"
    clock.advance(1.0)
    b.put("c.json", "C")
    assert b.evictions == 1
    assert b.list() == ["a.json", "c.json"]
    assert b.get("b.json") is None


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("kind", ("sqlite", "mem"))
def test_ttl_eviction_drops_stale_writes(pkg, kind, tmp_path):
    clock = FakeClock()
    C = PKGS[pkg]
    b = make_backend(C, kind, tmp_path, policy=C.EvictionPolicy(ttl_s=50.0),
                     clock=clock)
    b.put("old.json", "O")
    clock.advance(100.0)
    b.put("new.json", "N")
    assert b.evictions == 1 and b.list() == ["new.json"]


def test_dir_ttl_uses_file_mtime(tmp_path):
    b = make_backend(T_C, "dir", tmp_path,
                     policy=T_C.EvictionPolicy(ttl_s=50.0))
    b.put("old.json", "O")
    stale = time.time() - 100.0
    os.utime(b.path_for("old.json"), (stale, stale))
    assert b.sweep() == 1 and b.list() == []


def test_eviction_policy_validates():
    with pytest.raises(ValueError):
        T_C.EvictionPolicy(max_entries=0)
    with pytest.raises(ValueError):
        T_C.EvictionPolicy(ttl_s=0.0)
    p = T_C.EvictionPolicy()
    assert p.max_entries is None and p.ttl_s is None


def test_dir_backend_atomic_files_and_prune(tmp_path):
    b = make_backend(T_C, "dir", tmp_path)
    b.put("v1/deep/nested/x.json", "{}")
    p = b.path_for("v1/deep/nested/x.json")
    assert p.is_file() and p.read_text() == "{}"
    assert not list(b.root.rglob("*.tmp"))
    assert b.path_for("") == b.root
    b.delete("v1/deep/nested/x.json")
    b.prune_empty_dirs()
    assert not (b.root / "v1").exists()


def test_sqlite_two_handles_share_one_file(tmp_path):
    """Two handles of one file, one from each package, see each other's
    writes."""
    db = tmp_path / "shared.db"
    a, b = T_C.SqliteBackend(db), R_C.SqliteBackend(db)
    a.put("k.json", "from-port")
    assert b.get("k.json") == "from-port"
    b.put("k.json", "from-reference")
    assert a.get("k.json") == "from-reference"
    assert a.etag("k.json") == b.etag("k.json")


def test_mem_registry_shares_by_name():
    a = T_C.parse_backend("mem://torch-contract-shared")
    b = T_C.parse_backend("mem://torch-contract-shared")
    assert a is b
    a.put("k.json", "x")
    assert b.get("k.json") == "x"
    c, d = T_C.parse_backend("mem://"), T_C.parse_backend("mem://")
    assert c is not d and c.get("k.json") is None
    # each package keeps its own registry
    assert R_C.parse_backend("mem://torch-contract-shared").peek(
        "k.json") is None


def test_tiered_front_serves_after_back_loss():
    front, back = T_C.MemoryBackend(), T_C.MemoryBackend()
    t = T_C.TieredBackend(front, back)
    back.put("k.json", "v")
    assert t.get("k.json") == "v" and front.peek("k.json") == "v"
    back.delete("k.json")
    assert t.get("k.json") == "v"
    t.put("w.json", "x")
    assert back.peek("w.json") == "x"
    s = t.stats()
    assert s["front"]["backend"] == "mem" and s["back"]["backend"] == "mem"


def test_tiered_write_back_flush_and_etag_skip():
    front, back = T_C.MemoryBackend(), T_C.MemoryBackend()
    t = T_C.TieredBackend(front, back, write_back=True)
    t.put("a.json", "1")
    t.put("b.json", "2")
    assert back.peek("a.json") is None
    assert t.dirty() == ("a.json", "b.json")
    assert t.flush() == 2
    assert back.peek("a.json") == "1" and back.peek("b.json") == "2"
    assert t.flush() == 0
    t.put("a.json", "1")
    assert t.flush() == 0
    t.put("a.json", "new")
    assert t.flush() == 1 and back.peek("a.json") == "new"


def test_tiered_flush_interval_knob_validated():
    front, back = T_C.MemoryBackend(), T_C.MemoryBackend()
    t = T_C.TieredBackend(front, back, write_back=True, flush_interval_s=5.0)
    assert t.flush_interval_s == 5.0
    assert t.stats()["flush_interval_s"] == 5.0
    with pytest.raises(ValueError, match="positive"):
        T_C.TieredBackend(front, back, write_back=True, flush_interval_s=0.0)
    with pytest.raises(ValueError, match="write_back"):
        T_C.TieredBackend(front, back, flush_interval_s=5.0)


def test_parse_backend_resolution(tmp_path):
    assert isinstance(T_C.parse_backend(tmp_path), T_C.LocalDirBackend)
    assert isinstance(T_C.parse_backend(str(tmp_path)), T_C.LocalDirBackend)
    d = T_C.parse_backend(f"dir://{tmp_path}/sub")
    assert isinstance(d, T_C.LocalDirBackend) and d.root == tmp_path / "sub"
    assert isinstance(T_C.parse_backend(f"sqlite://{tmp_path}/c.db"),
                      T_C.SqliteBackend)
    m = T_C.parse_backend("mem://p9-torch")
    assert isinstance(m, T_C.MemoryBackend) and m.name == "p9-torch"
    b = T_C.MemoryBackend()
    assert T_C.parse_backend(b) is b
    for bad in ("sqlite://", "dir://", "redis://nope"):
        with pytest.raises(ValueError):
            T_C.parse_backend(bad)
    with pytest.raises(TypeError):
        T_C.parse_backend(42)


def test_backend_base_class_is_abstract():
    with pytest.raises(NotImplementedError):
        T_C.StoreBackend().get("x.json")


# ---------------------------------------------------------------------------
# ProfileStore over backends
# ---------------------------------------------------------------------------


def _table_args(batches=(1, 4), seed=7):
    labels = tuple(f"L{s.idx}:{s.notation}" for s in MODEL.specs)
    rng = np.random.default_rng(seed)
    times, kernels, h2d, d2h = {}, {}, {}, {}
    for b in batches:
        times[b], kernels[b], h2d[b], d2h[b] = [], [], [], []
        for _ in labels:
            krow = {c: float(rng.uniform(1e-6, 1e-3)) for c in CONFIGS}
            up, down = (float(x) for x in rng.uniform(1e-6, 5e-4, 2))
            kernels[b].append(krow)
            times[b].append({c: krow[c] if c == CPU else krow[c] + up + down
                             for c in CONFIGS})
            h2d[b].append(up)
            d2h[b].append(down)
    return (MODEL.name, tuple(batches), labels, times), dict(
        kernel_times=kernels, h2d_times=h2d, d2h_times=d2h)


def test_plain_directory_roots_load_through_every_spelling(tmp_path):
    args, kw = _table_args()
    t = ProfileTable(*args, **kw)
    old = T_S.ProfileStore(tmp_path, fingerprint="fp-compat")
    assert old.save_profile(t).is_file()
    ec = T_MAP.map_efficient_configuration(t, policy="dp")
    old.save_mapping(ec)
    for spec in (tmp_path, f"dir://{tmp_path}", T_C.LocalDirBackend(tmp_path)):
        store = T_S.ProfileStore(spec, fingerprint="fp-compat")
        got = store.load_profile(MODEL, (1, 4))
        assert got is not None and got.times == t.times
        cfg = store.load_mapping(MODEL, policy="dp",
                                 batch=ec.proper_batch_size)
        assert cfg.layer_configs == ec.layer_configs


def test_profile_store_round_trips_through_sqlite(tmp_path):
    args, kw = _table_args()
    t = ProfileTable(*args, **kw)
    uri = f"sqlite://{tmp_path}/store.db"
    a = T_S.ProfileStore(uri, fingerprint="fp-sql")
    a.save_profile(t)
    ec = T_MAP.map_efficient_configuration(t, policy="dp")
    a.save_mapping(ec)
    b = T_S.ProfileStore(uri, fingerprint="fp-sql")
    got = b.load_profile(MODEL, (1, 4))
    assert got is not None and got.times == t.times
    cfg = b.load_mapping(MODEL, policy="dp", batch=ec.proper_batch_size)
    assert cfg.layer_configs == ec.layer_configs
    assert sorted(e.kind for e in b.entries()) == [
        "efficient_configuration", "profile_table"]
    assert [p.name for p in tmp_path.iterdir()
            if not p.name.startswith("store.db")] == []
    stats = b.stats()
    assert stats["backend"] == "sqlite" and stats["entries"] == 2


def test_store_stats_counts_hits_and_misses():
    args, kw = _table_args()
    store = T_S.ProfileStore("mem://", fingerprint="fp-stats")
    assert store.load_profile(MODEL, (1, 4)) is None
    store.save_profile(ProfileTable(*args, **kw))
    assert store.load_profile(MODEL, (1, 4)) is not None
    s = store.stats()
    assert s["hits"] == 1 and s["misses"] >= 1 and s["puts"] == 1


# ---------------------------------------------------------------------------
# work queue: dedupe, retry/backoff under virtual time, journal
# ---------------------------------------------------------------------------


def _journal(q):
    return [r.to_dict() for r in q.journal]


def test_submit_dedupes_live_identities():
    q = T_C.WorkQueue(clock=FakeClock())
    assert q.submit("prewarm", "k1", lambda: None) is True
    assert q.submit("prewarm", "k1", lambda: None) is False
    assert q.submit("refit", "k1", lambda: None) is True
    assert q.submit("prewarm", "k2", lambda: None) is True
    assert q.stats()["submitted"] == 3 and q.stats()["deduped"] == 1
    q.run_pending()
    assert q.submit("prewarm", "k1", lambda: None) is True


def test_retry_backoff_schedule_is_virtual_time_only():
    journals = []
    for C in PKGS.values():
        clock = FakeClock()
        q = C.WorkQueue(clock=clock, max_attempts=3, backoff_s=0.5)
        attempt_times = []

        def flaky():
            attempt_times.append(clock())
            if len(attempt_times) < 3:
                raise RuntimeError("transient")
            return {"ok": True}

        q.submit("prewarm", "k", flaky)
        wall = time.monotonic()
        assert q.drain(sleep=clock.advance) == 3
        assert time.monotonic() - wall < 1.0
        assert attempt_times[1] - attempt_times[0] == pytest.approx(0.5)
        assert attempt_times[2] - attempt_times[1] == pytest.approx(1.0)
        assert q.stats()["retries"] == 2
        (rec,) = q.journal
        assert rec.status == "done" and rec.attempts == 3
        journals.append(_journal(q))
    assert journals[0] == journals[1]


def test_permanent_failure_journaled_after_max_attempts():
    journals = []
    for C in PKGS.values():
        clock = FakeClock()
        q = C.WorkQueue(clock=clock, max_attempts=2, backoff_s=0.1)

        def broken():
            raise ValueError("planted failure")

        q.submit("explore", "bad-key", broken)
        assert q.drain(sleep=clock.advance) == 2
        (rec,) = q.journal
        assert rec.status == "failed" and rec.attempts == 2
        assert rec.error == "ValueError: planted failure"
        assert q.stats() == {
            "queued": 0, "running": 0, "repeating": 0, "submitted": 1,
            "deduped": 0, "retries": 1, "done": 0, "failed": 1}
        journals.append(_journal(q))
    assert journals[0] == journals[1]


def test_run_pending_respects_backoff_deadlines():
    clock = FakeClock()
    q = T_C.WorkQueue(clock=clock, max_attempts=3, backoff_s=1.0)
    calls = []

    def once_flaky():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("once")

    q.submit("refit", "k", once_flaky)
    assert q.run_pending() == 1 and q.pending() == 1
    assert q.run_pending() == 0
    assert q.next_due_s() == pytest.approx(1.0)
    clock.advance(1.0)
    assert q.run_pending() == 1 and q.journal[-1].status == "done"


def test_job_record_to_dict_round_trips():
    clock = FakeClock()
    q = T_C.WorkQueue(clock=clock)
    clock.advance(3.0)
    q.submit("prewarm", "k", lambda: {"n": 1})
    q.run_pending()
    d = q.journal[0].to_dict()
    assert d["seq"] == 0 and d["kind"] == "prewarm"
    assert d["enqueued_s"] == 3.0 and d["finished_s"] == 3.0
    assert d["result"] == {"n": 1}


def test_worker_pool_drains_in_background():
    q = T_C.WorkQueue()
    done = []
    for i in range(8):
        q.submit("prewarm", f"k{i}", lambda i=i: done.append(i))
    pool = T_C.WorkerPool(q, n_workers=3).start()
    try:
        with pytest.raises(RuntimeError):
            pool.start()
        assert pool.alive == 3
        assert pool.join_idle(timeout=5.0)
        assert sorted(done) == list(range(8))
        assert all(r.status == "done" for r in q.journal)
    finally:
        pool.stop(timeout=5.0)
    assert pool.alive == 0


def test_worker_pool_stress_runs_each_job_once_and_dedupes():
    """More workers than cores, a short switch interval, concurrent
    submitters racing on the same identities: every accepted submission
    runs exactly once, every identity runs, and the journal's sequence
    numbers are unique and dense."""
    q = T_C.WorkQueue()
    ran: list = []
    lock = threading.Lock()

    def job(i):
        with lock:
            ran.append(i)

    n_jobs = 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    pool = T_C.WorkerPool(q, n_workers=2 * (os.cpu_count() or 4),
                          poll_s=0.001).start()
    try:
        def submitter():
            for i in range(n_jobs):
                q.submit("prewarm", f"k{i}", lambda i=i: job(i))

        threads = [threading.Thread(target=submitter) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert pool.join_idle(timeout=30.0)
    finally:
        pool.stop(timeout=5.0)
        sys.setswitchinterval(old)
    assert pool.alive == 0
    journal = q.journal
    assert sorted(r.seq for r in journal) == list(range(len(journal)))
    assert len(ran) == len(journal) and len(set(ran)) == n_jobs
    assert all(r.status == "done" for r in journal)
    stats = q.stats()
    assert stats["submitted"] + stats["deduped"] == 4 * n_jobs
    assert stats["submitted"] == len(journal)


def test_queue_validates_knobs():
    with pytest.raises(ValueError):
        T_C.WorkQueue(max_attempts=0)
    with pytest.raises(ValueError):
        T_C.WorkQueue(backoff_s=-1.0)
    with pytest.raises(ValueError):
        T_C.WorkerPool(T_C.WorkQueue(), n_workers=0)
    q = T_C.WorkQueue()
    with pytest.raises(ValueError):
        q.submit("k", "k", lambda: None, delay_s=-1.0)
    with pytest.raises(ValueError):
        q.submit("k", "k", lambda: None, repeat_s=0.0)


def test_periodic_job_repeats_on_its_cadence_until_cancelled():
    journals = []
    for C in PKGS.values():
        clock = FakeClock()
        q = C.WorkQueue(clock=clock)
        runs = []
        assert q.submit("flush", "tier",
                        lambda: runs.append(clock()) or {"n": 1},
                        delay_s=2.0, repeat_s=2.0) is True
        try:
            assert q.submit("flush", "tier", lambda: None) is False
            assert q.run_pending() == 0 and q.stats()["repeating"] == 1
            clock.advance(2.0)
            assert q.run_pending() == 1 and q.run_pending() == 0
            clock.advance(2.0)
            assert q.run_pending() == 1
            assert runs == [2.0, 4.0]
        finally:
            assert q.cancel("flush", "tier") is True
        clock.advance(10.0)
        assert q.run_pending() == 0
        assert q.cancel("flush", "tier") is False
        journals.append(_journal(q))
    assert journals[0] == journals[1]


def test_periodic_job_survives_failed_tick_and_drain_terminates():
    clock = FakeClock()
    q = T_C.WorkQueue(clock=clock, max_attempts=1)
    ticks = []

    def flaky():
        ticks.append(1)
        if len(ticks) == 1:
            raise RuntimeError("one bad tick")
        return {"ok": True}

    q.submit("flush", "k", flaky, repeat_s=1.0)
    q.submit("prewarm", "p", lambda: {"done": True})
    try:
        q.drain(sleep=clock.advance)
        assert any(r.kind == "prewarm" and r.status == "done"
                   for r in q.journal)
        flush_recs = [r for r in q.journal if r.kind == "flush"]
        assert flush_recs[0].status == "failed" and q.pending() == 1
        clock.advance(1.0)
        assert q.run_pending() == 1
        assert q.journal[-1].result == {"ok": True}
    finally:
        q.cancel("flush", "k")


def test_periodic_job_can_cancel_itself_mid_run():
    q = T_C.WorkQueue(clock=FakeClock())

    def last_tick():
        q.cancel("flush", "self")
        return {"last": True}

    q.submit("flush", "self", last_tick, repeat_s=1.0)
    assert q.run_pending() == 1 and q.pending() == 0
    assert q.journal[-1].status == "done"


def test_join_idle_ignores_dormant_periodic_jobs():
    q = T_C.WorkQueue()
    q.submit("flush", "timer", lambda: None, delay_s=60.0, repeat_s=60.0)
    q.submit("prewarm", "k", lambda: {"n": 1})
    pool = T_C.WorkerPool(q, n_workers=1).start()
    try:
        assert pool.join_idle(timeout=5.0) is True
    finally:
        pool.stop(timeout=5.0)
        q.cancel("flush", "timer")
    assert q.stats()["done"] == 1 and pool.alive == 0


# ---------------------------------------------------------------------------
# job bodies: equal results on equal tables
# ---------------------------------------------------------------------------


def _both_tables(rows_fn, batch=4, bnd=1e-5):
    """(reference table, port table) whose kernel row per layer is
    ``rows_fn(config)``, boundary `bnd` each way."""
    n = len(MODEL.specs)
    labels = tuple(f"L{s.idx}:{s.notation}" for s in MODEL.specs)
    times = {batch: [{c: rows_fn(c) if c == CPU else rows_fn(c) + 2 * bnd
                      for c in CONFIGS} for _ in range(n)]}
    kernels = {batch: [{c: rows_fn(c) for c in CONFIGS} for _ in range(n)]}
    args = (MODEL.name, (batch,), labels, times)
    kw = dict(kernel_times=kernels, h2d_times={batch: [bnd] * n},
              d2h_times={batch: [bnd] * n})
    return R_Table(*args, **kw), ProfileTable(*args, **kw)


def _stale(cpu=1e-3, dev=5e-3):
    """Device rows stale-slow: the mapper pins everything to the host,
    so device placements never execute."""
    return _both_tables(lambda c: cpu if c == CPU else dev)


def _decoy(cpu=1e-3, decoy=2e-3, dev=5e-3):
    """One device config (X) stored cheapest and accurate, every other
    device config stored slow but really fast."""
    return _both_tables(lambda c: cpu if c == CPU else
                        decoy if c == "X" else dev)


def _same_rows_registry():
    reg = R_REG.VariantRegistry()
    for v in T_REG.DEFAULT_REGISTRY:
        reg.register(R_REG.KernelVariant(
            name=v.name, builder=v.builder, placement=v.placement,
            scope=v.scope, aspects=tuple(v.aspects), p_blk=v.p_blk,
            n_blk=v.n_blk, analytic=v.analytic))
    return reg


def _stores(tmp_path, uri="dir"):
    """(reference store, port store) under one fingerprint and equal
    registry rows, each on its own root."""
    def root(pkg):
        return (f"sqlite://{tmp_path}/{pkg}.db" if uri == "sqlite"
                else tmp_path / pkg)
    return (R_S.ProfileStore(root("reference"), fingerprint="fp",
                             registry=_same_rows_registry()),
            T_S.ProfileStore(root("port"), fingerprint="fp"))


def _explore_both(tmp_path, tables, measure_fn, sweep="cheapest", steps=25):
    """Run explore_once in both packages on the same table, saved old
    mapping and counts; the result dicts must be equal."""
    r_store, store = _stores(tmp_path, "sqlite")
    outs = []
    for J, MAP, st, t, m in ((R_J, R_MAP, r_store, tables[0], R_MODEL),
                             (T_J, T_MAP, store, tables[1], MODEL)):
        old = MAP.map_efficient_configuration(t, policy="dp",
                                              batch_sizes=(4,))
        st.save_mapping(old)
        counts = J.execution_counts(old, steps=steps)
        outs.append((J.explore_once(st, m, t, batch=4, counts=counts,
                                    measure_fn=measure_fn, sweep=sweep),
                     old, counts))
    assert outs[0][0] == outs[1][0]
    return store, outs[1]


def test_execution_counts_accumulates_across_mappings():
    t = ProfileTable.from_json(flat_table(MODEL).to_json())
    host = T_MAP.map_efficient_configuration(t, policy="greedy")
    counts = T_J.execution_counts(host, 10)
    assert all(n == 10 for n in counts.values())
    assert len(counts) == len(t.layer_labels)
    counts = T_J.execution_counts(host, 5, into=counts)
    assert all(n == 15 for n in counts.values())
    r_t = flat_table(R_MODEL)
    r_host = R_MAP.map_efficient_configuration(r_t, policy="greedy")
    assert counts == R_J.execution_counts(
        r_host, 5, into=R_J.execution_counts(r_host, 10))


def test_coverage_report_flags_unexecuted_placements():
    r_t, t = _stale()
    solo = T_MAP.map_efficient_configuration(t, policy="dp")
    assert all(placement_of(c) == HOST for c in solo.layer_configs)
    counts = T_J.execution_counts(solo, steps=10)
    rows = T_J.coverage_report(t, 4, counts)
    assert len(rows) == len(t.layer_labels)
    assert all(r.placement == DEVICE and r.executed == 0 for r in rows)
    assert all(r.candidates for r in rows)
    for kw in ({}, {"min_count": 11}):
        assert [dataclasses.astuple(r) for r in T_J.coverage_report(
            t, 4, counts, **kw)] == [dataclasses.astuple(r) for r in
                                     R_J.coverage_report(r_t, 4, counts, **kw)]
    assert len(T_J.coverage_report(t, 4, counts, min_count=11)) == (
        2 * len(t.layer_labels))
    with pytest.raises(ValueError):
        T_J.coverage_report(t, 16, counts)


def test_prewarm_once_is_idempotent_and_equal_to_reference(tmp_path):
    fp = T_M.random_fp_params(MODEL.specs, 0)
    packed = T_M.pack_params(MODEL.specs, fp, device="cpu")
    r_store, store = _stores(tmp_path, "sqlite")
    results = []
    for J, st, m, to in ((R_J, r_store, R_MODEL, lambda t: t),
                         (T_J, store, MODEL,
                          lambda t: ProfileTable.from_json(t.to_json()))):
        calls = {"profile": 0}

        def profile_fn(model, pp, *, batch_sizes):
            calls["profile"] += 1
            return to(flat_table(R_MODEL, batch=batch_sizes[0]))

        r1 = J.prewarm_once(st, m, packed, profile_fn=profile_fn,
                            batch_sizes=(4,))
        assert r1["profiled"] is True and r1["mapped"] is True
        r2 = J.prewarm_once(st, m, packed, profile_fn=profile_fn,
                            batch_sizes=(4,))
        assert r2["profiled"] is False and r2["mapped"] is False
        assert calls["profile"] == 1 and r2["batch"] == r1["batch"]
        results.append((r1, r2))
    assert results[0] == results[1]


def _refit_stores(tmp_path, model):
    """A port and a reference store holding the same training rows (one
    profiled sweep of `model`), same fingerprint and registry rows."""
    port = T_S.ProfileStore(tmp_path / "port", fingerprint="fp")
    ref = R_S.ProfileStore(tmp_path / "ref", fingerprint="fp",
                           registry=_same_rows_registry())
    rows = R_E.training_rows_from_table(model, loglinear_table(model))
    for store in (port, ref):
        store.save_training_rows(rows, source="sweep")
    return port, ref, len(rows)


@pytest.mark.parametrize("min_new", [1, 8, 10**6])
def test_refit_once_equal_to_reference_and_thresholds(tmp_path, min_new):
    m = synthetic_model("refit")
    port, ref, n = _refit_stores(tmp_path, m)
    for _ in range(2):             # the second pass: no new rows
        got = T_J.refit_once(port, min_new_rows=min_new)
        want = R_J.refit_once(ref, min_new_rows=min_new)
        assert got == want
    first = n >= min_new
    assert got["new_rows"] == (0 if first else n)
    assert (port.load_predictor() is not None) == first
    if first:
        assert port.predictor_meta()["source_rows"] == n
        assert port.load_predictor().to_json() == (
            ref.load_predictor().to_json())


@pytest.mark.parametrize("gamma", [0.3, 0.8])
def test_refit_once_fits_interference_equal_to_reference(tmp_path, gamma):
    ledger, expected = planted_gamma_ledger(gamma)
    # the same closed steps in the port's own ledger
    own = T_F.DeviceTimeLedger(window=ledger.window)
    for tenant in ledger.tenants():
        for host_s, dev_s in ledger.step_rows(tenant):
            own.record(tenant, HOST, host_s)
            own.record(tenant, DEVICE, dev_s)
            own.close_step(tenant)
    port = T_S.ProfileStore(tmp_path / "port", fingerprint="fp")
    ref = R_S.ProfileStore(tmp_path / "ref", fingerprint="fp")
    got = T_J.refit_once(port, observations=(own, expected))
    want = R_J.refit_once(ref, observations=(ledger, expected))
    assert got == want and got["interference"] is True
    assert got["gamma"] == pytest.approx(gamma, abs=1e-9)
    assert port.load_interference().to_json() == (
        ref.load_interference().to_json())


def test_explore_corrects_planted_stale_row(tmp_path):
    measured = []

    def measure_fn(layer, config, batch):
        measured.append((layer, config, batch))
        return 1e-4

    store, (out, old, counts) = _explore_both(tmp_path, _stale(), measure_fn)
    r_t, t = _stale()
    assert out["explored"] == len(t.layer_labels) and out["improved"] is True
    assert out["new_expected_s"] < out["old_expected_s"]
    assert len(measured) == 2 * len(t.layer_labels)
    assert all(placement_of(c) == DEVICE for _, c, _ in measured)
    refreshed = store.load_mapping(MODEL, policy="dp", batch=4)
    assert refreshed.layer_configs != old.layer_configs
    assert all(placement_of(c) == DEVICE for c in refreshed.layer_configs)
    assert t.kernel_time(4, 0, refreshed.layer_configs[0]) == 5e-3
    covered = T_J.execution_counts(refreshed, 25, into=dict(counts))
    out2 = T_J.explore_once(store, MODEL, t, batch=4, counts=covered,
                            measure_fn=measure_fn)
    assert out2 == {"explored": 0, "improved": False, "sweep": "cheapest"}


def test_explore_keeps_old_mapping_when_measurement_confirms(tmp_path):
    r_t, t = _stale()
    store, (out, old, _) = _explore_both(
        tmp_path, (r_t, t), lambda layer, c, b: t.kernel_time(b, layer, c))
    assert out["improved"] is False
    kept = store.load_mapping(MODEL, policy="dp", batch=4)
    assert kept.layer_configs == old.layer_configs


def test_explore_frontier_sweeps_every_stale_candidate(tmp_path):
    r_t, t = _stale()
    store, (out, old, counts) = _explore_both(
        tmp_path, (r_t, t), lambda l, c, b: 1e-4, sweep="frontier")
    rows = T_J.coverage_report(t, 4, counts)
    n_candidates = sum(len(r.candidates) for r in rows)
    assert out["sweep"] == "frontier" and out["explored"] == len(rows)
    assert out["measured"] == n_candidates > out["explored"]
    assert out["improved"] is True
    for r in out["rows"]:
        assert r["stored_s"] == 5e-3 and r["observed_s"] == 1e-4
        assert r["ratio"] == pytest.approx(1e-4 / 5e-3)
    refreshed = store.load_mapping(MODEL, policy="dp", batch=4)
    assert all(placement_of(c) == DEVICE for c in refreshed.layer_configs)
    with pytest.raises(ValueError):
        T_J.explore_once(store, MODEL, t, batch=4, counts=counts,
                         measure_fn=lambda l, c, b: 1e-4, sweep="bogus")


def test_frontier_catches_mispriced_non_cheapest_candidate(tmp_path):
    def truth(layer, config, batch):
        return 2e-3 if config == "X" else 1e-4

    store, (out, old, counts) = _explore_both(
        tmp_path / "cheapest", _decoy(), truth, sweep="cheapest")
    assert out["improved"] is False
    assert all(r["config"] == "X" and r["ratio"] == 1.0 for r in out["rows"])
    assert store.load_mapping(MODEL, policy="dp", batch=4).layer_configs == (
        old.layer_configs)
    store, (out, _, _) = _explore_both(
        tmp_path / "frontier", _decoy(), truth, sweep="frontier")
    assert out["improved"] is True
    refreshed = store.load_mapping(MODEL, policy="dp", batch=4)
    assert all(placement_of(c) == DEVICE and c != "X"
               for c in refreshed.layer_configs)


def test_flush_once_pushes_dirty_keys_then_is_idempotent():
    results = []
    for C, J in ((R_C, R_J), (T_C, T_J)):
        front, back = C.MemoryBackend(), C.MemoryBackend()
        tier = C.TieredBackend(front, back, write_back=True)
        tier.put("a/x.json", "1")
        tier.put("a/y.json", "2")
        assert back.get("a/x.json") is None
        results.append((J.flush_once(tier), J.flush_once(tier)))
        assert back.get("a/x.json") == "1" and back.get("a/y.json") == "2"
    assert results[0] == results[1] == (
        {"pushed": 2, "pending": 0}, {"pushed": 0, "pending": 0})


# ---------------------------------------------------------------------------
# CacheService
# ---------------------------------------------------------------------------


def _service(tmp_path, **kwargs):
    m1 = T_M.build_model("fashion_mnist", scale=0.25)
    m2 = T_M.build_model("fashion_mnist", scale=0.5)
    calls = {"profile": 0}

    def profile_fn(model, pp, *, batch_sizes):
        calls["profile"] += 1
        return ProfileTable.from_json(
            flat_table(model, batch=batch_sizes[0]).to_json())

    svc = T_C.CacheService(
        T_S.ProfileStore(tmp_path, fingerprint="fp"),
        profile_fn=profile_fn, batch_sizes=(4,),
        clock=kwargs.pop("clock", FakeClock()), **kwargs)
    svc.register("small", m1, None)
    svc.register("large", m2, None)
    return svc, calls


def test_service_prewarm_jobs_dedupe_and_journal(tmp_path):
    svc, calls = _service(tmp_path)
    assert svc.catalog == ("large", "small")
    assert svc.enqueue_prewarm("small") is True
    assert svc.enqueue_prewarm("small") is False
    assert svc.enqueue_prewarm("large") is True
    assert svc.run_pending() == 2 and calls["profile"] == 2
    recs = svc.journal
    assert [r.kind for r in recs] == ["prewarm", "prewarm"]
    assert all(r.status == "done" and r.result["profiled"] for r in recs)
    assert recs[0].key.endswith("profile-b4.json")
    assert svc.enqueue_prewarm("small") is True
    svc.run_pending()
    assert calls["profile"] == 2
    assert svc.journal[-1].result == {
        "profiled": False, "mapped": False, "batch": 4,
        "expected_s": svc.journal[-1].result["expected_s"]}


def test_service_popularity_ranks_by_store_access(tmp_path):
    svc, _ = _service(tmp_path)
    svc.enqueue_prewarm("small")
    svc.enqueue_prewarm("large")
    svc.run_pending()
    m2, _ = svc._catalog["large"]
    for _ in range(3):
        assert svc.store.load_profile(m2, (4,)) is not None
    pop = svc.popularity()
    assert pop["large"] > pop["small"]
    assert svc.prewarm_popular(top=1) == 1
    svc.run_pending()
    assert svc._sig("large") in svc.journal[-1].key
    s = svc.stats()
    assert s["store"]["hits"] >= 3 and s["queue"]["done"] == 3


def test_service_refit_is_journaled_as_failed_and_guards(tmp_path):
    """A queued refit fits and persists a predictor on the rows the
    prewarm recorded; it is journaled done (never a failed job), deduped
    while queued, and the service's guards still refuse a model without
    a profiler or a measurement function."""
    svc, _ = _service(tmp_path, max_attempts=2)
    svc.enqueue_prewarm("small")
    svc.run_pending()                        # records training rows
    n_rows = len(svc.store.load_training_rows())
    assert n_rows > 0
    svc.refit_min_new_rows = 1
    assert svc.enqueue_refit() is True
    assert svc.enqueue_refit() is False
    assert svc.drain(sleep=svc.queue.clock.advance) == 1
    rec = svc.journal[-1]
    assert rec.kind == "refit" and rec.status == "done"
    assert rec.attempts == 1 and not rec.error
    assert rec.result["refit"] is True and rec.result["rows"] == n_rows
    assert svc.store.predictor_meta()["source_rows"] == n_rows
    assert svc.store.load_predictor().n_rows == rec.result["n_rows"]
    model, packed = svc._catalog["small"]
    bare = T_C.CacheService(T_S.ProfileStore(tmp_path / "bare",
                                             fingerprint="fp"))
    bare.register("m", model, packed)
    with pytest.raises(ValueError):
        bare.enqueue_prewarm("m")
    with pytest.raises(ValueError):
        bare.enqueue_explore("m", ProfileTable.from_json(
            flat_table(model).to_json()), batch=4, counts={})


def test_service_explore_closes_stale_row_through_queue(tmp_path):
    _, t = _stale()
    store = T_S.ProfileStore(tmp_path, fingerprint="fp")
    old = T_MAP.map_efficient_configuration(t, policy="dp", batch_sizes=(4,))
    store.save_mapping(old)
    svc = T_C.CacheService(store, measure_fn=lambda l, c, b: 1e-4,
                           clock=FakeClock())
    svc.register("m", MODEL, None)
    assert svc.enqueue_explore(
        "m", t, batch=4, counts=T_J.execution_counts(old, 25)) is True
    assert svc.drain(sleep=svc.queue.clock.advance) == 1
    rec = svc.journal[-1]
    assert rec.kind == "explore" and rec.status == "done"
    assert rec.result["improved"] is True
    assert store.load_mapping(MODEL, policy="dp", batch=4).layer_configs != (
        old.layer_configs)


def test_service_timed_write_back_flush(tmp_path):
    front, back = T_C.MemoryBackend("t-svc-f"), T_C.MemoryBackend("t-svc-b")
    tier = T_C.TieredBackend(front, back, write_back=True,
                             flush_interval_s=5.0)
    clock = FakeClock()
    svc = T_C.CacheService(T_S.ProfileStore(tier, fingerprint="fp"),
                           clock=clock)
    tier.put("k.json", "v")
    assert svc.enqueue_flush() is True
    try:
        assert svc.enqueue_flush() is False
        assert svc.run_pending() == 0
        clock.advance(5.0)
        assert svc.run_pending() == 1
        rec = svc.journal[-1]
        assert rec.kind == "flush" and rec.key == tier.uri()
        assert rec.result == {"pushed": 1, "pending": 0}
        assert back.get("k.json") == "v"
        tier.put("k2.json", "v2")
        clock.advance(5.0)
        assert svc.run_pending() == 1 and back.get("k2.json") == "v2"
        assert svc.queue.stats()["repeating"] == 1
    finally:
        assert svc.queue.cancel("flush", tier.uri()) is True


def test_service_one_shot_flush_and_backend_guard(tmp_path):
    front, back = T_C.MemoryBackend("t-os-f"), T_C.MemoryBackend("t-os-b")
    tier = T_C.TieredBackend(front, back, write_back=True)
    svc = T_C.CacheService(T_S.ProfileStore(tier, fingerprint="fp"),
                           clock=FakeClock())
    tier.put("x.json", "1")
    assert svc.enqueue_flush() is True
    assert svc.run_pending() == 1 and svc.queue.stats()["repeating"] == 0
    assert back.get("x.json") == "1"
    assert svc.enqueue_flush() is True
    bare = T_C.CacheService(T_S.ProfileStore(tmp_path, fingerprint="fp"))
    with pytest.raises(ValueError, match="flush"):
        bare.enqueue_flush()


def test_service_workers_take_jobs_off_thread(tmp_path):
    svc, calls = _service(tmp_path, clock=time.monotonic)
    svc.enqueue_prewarm("small")
    svc.enqueue_prewarm("large")
    pool = svc.workers(2)
    try:
        assert pool.join_idle(timeout=10.0)
    finally:
        pool.stop(timeout=5.0)
    assert pool.alive == 0 and calls["profile"] == 2
    assert sorted(r.status for r in svc.journal) == ["done", "done"]


def test_cluster_warm_starts_scale_up_from_shared_store():
    from tests.test_cluster import FakeEngine

    from repro import api as R_API
    from repro.cluster import Cluster as R_Cluster
    from repro_torch import api as T_API
    from repro_torch.cluster import Cluster

    def tenant(api, mapper, conv, name):
        table = conv(tied_table(name))
        config = mapper.price_mapping(table, 4,
                                      [CPU] * len(table.layer_labels))
        return api.TenantPlan(name=name, model=None, packed=[], table=table,
                              config=config)

    def factory(tp, config, **_kw):
        return FakeEngine(config)

    runs = []
    for cls, api, mapper, conv, kw in (
        (Cluster, T_API, T_MAP, lambda t: ProfileTable.from_json(
            t.to_json()), {"device": "cpu"}),
        (R_Cluster, R_API, R_MAP, lambda t: t, {}),
    ):
        cluster = cls([tenant(api, mapper, conv, n) for n in ("a", "b")],
                      n_hosts=1, engine_factory=factory, clock=FakeClock(),
                      batch_sizes=(4,), store="mem://torch-warm-start", **kw)
        assert cluster.cache_hits == 0 and cluster.cache_misses == 0
        cluster.scale_up()
        # replicating onto the empty host first re-maps tenant a solo (a
        # group never seen: miss), then lands on the seeded {a, b}
        # joint group: hit — the mapper run is skipped
        assert (cluster.cache_hits, cluster.cache_misses) == (1, 1)
        stats = cluster.stats()
        assert stats["cache"]["hits"] == 1
        assert stats["cache"]["backend"]["backend"] == "mem"
        for name in ("a", "b"):
            assert len(cluster._hosts_for(name)) == 2
        runs.append({n: [(h.host_id, h.router.tenant(n).engine.config.to_json())
                         for h in cluster._hosts_for(n)] for n in ("a", "b")})
    assert runs[0] == runs[1]
