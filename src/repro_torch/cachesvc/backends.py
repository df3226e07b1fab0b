"""Pluggable storage backends behind :class:`~repro_torch.store.ProfileStore`.

The store's artifacts are small keyed JSON documents; everything a
backend must do is string-keyed text I/O::

    key:  "v1/<fingerprint>[/s-<scope>]/<model>-r<registry>/<file>.json"
    text: the versioned envelope the store writes today

Three backends share that contract (a copy of the JAX package's
``repro.cachesvc.backends``, held to one contract suite with it):

* :class:`LocalDirBackend` — the on-disk layout, bit-compatible with
  the JAX package's: keys map 1:1 to files under the root, written
  atomically (tmp + ``os.replace``), so a root written by either
  package reads back in the other.
* :class:`SqliteBackend` — one shareable file (stdlib ``sqlite3``,
  WAL journal) safe for concurrent readers while a writer commits;
  several processes or hosts can share it.
* :class:`MemoryBackend` — in-process dict, for tests and ephemeral
  caches.  ``mem://<name>`` URIs resolve to one shared instance per
  name, so several handles in one process share a cache the way
  several hosts share a sqlite file.

Every backend carries **per-key ETags** (content digests — cheap
change detection for read-through promotion), **hit/miss/eviction
counters** plus per-key access counts (the popularity signal the
cache service's ``prewarm`` worker ranks by), and an optional
:class:`EvictionPolicy` (max-entry LRU + TTL) applied on writes and
:meth:`StoreBackend.sweep`.

:class:`TieredBackend` composes two backends read-through: a
host-local front (typically ``dir://`` or ``mem://``) over a shared
back (typically ``sqlite://``).  Reads hit the front first and promote
back-tier hits; writes go through to both (or, with
``write_back=True``, are journaled dirty and pushed by
:meth:`TieredBackend.flush`).

:func:`parse_backend` selects by URI: ``dir://path``,
``sqlite://path``, ``mem://name`` — a bare path is a dir backend, so
every call site that accepted a root ``Path`` keeps working.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import sqlite3
import threading
import time
from pathlib import Path


def _etag_of(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:12]


def validate_key(key: str) -> str:
    """Keys are relative POSIX paths — no absolute paths, no parent
    escapes, no empty segments (a dir backend joins them under its
    root, so a hostile key must never leave it)."""
    if not key or key.startswith("/") or "\\" in key or "\0" in key:
        raise ValueError(f"invalid store key {key!r}")
    # split on the raw separator: PurePosixPath normalizes a leading
    # "./" away, which would let dot segments through
    if any(p in ("..", ".", "") for p in key.split("/")):
        raise ValueError(f"invalid store key {key!r} (relative escapes)")
    return key


@dataclasses.dataclass(frozen=True)
class EvictionPolicy:
    """Bounds a backend: at most ``max_entries`` keys (evicting the
    least-recently-*accessed* first — LRU) and nothing older than
    ``ttl_s`` since it was written.  ``None`` disables a bound; the
    default policy bounds nothing (profile stores are tiny and a
    silently-evicted profile re-profiles, so bounded caches are
    opt-in)."""

    max_entries: int | None = None
    ttl_s: float | None = None

    def __post_init__(self):
        if self.max_entries is not None and self.max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        if self.ttl_s is not None and self.ttl_s <= 0:
            raise ValueError("ttl_s must be positive")


class StoreBackend:
    """Counter bookkeeping shared by every backend.  Subclasses
    implement ``_read/_write/_delete/_keys`` plus timestamp lookups;
    the public API (get/peek/put/delete/list/etag/stats) lives here so
    hit/miss/eviction accounting is uniform."""

    scheme = "?"

    def __init__(self, *, policy: EvictionPolicy | None = None,
                 clock=time.time):
        self.policy = policy or EvictionPolicy()
        self._clock = clock
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.deletes = 0
        self.evictions = 0
        self._access: dict = {}        # key -> get() count (per handle)

    # -- subclass surface --------------------------------------------
    def _read(self, key: str) -> str | None:
        raise NotImplementedError

    def _write(self, key: str, text: str) -> None:
        raise NotImplementedError

    def _delete(self, key: str) -> bool:
        raise NotImplementedError

    def _keys(self) -> list:
        raise NotImplementedError

    def _saved_at(self, key: str) -> float:
        raise NotImplementedError

    def _accessed_at(self, key: str) -> float:
        raise NotImplementedError

    def _touch(self, key: str) -> None:
        """Record an access for LRU ordering (default: in-memory)."""

    # -- public contract ---------------------------------------------
    def get(self, key: str) -> str | None:
        """The stored text, counting a hit or miss and feeding the
        per-key access counter (the prewarm popularity signal)."""
        text = self._read(validate_key(key))
        with self._lock:
            if text is None:
                self.misses += 1
            else:
                self.hits += 1
                self._access[key] = self._access.get(key, 0) + 1
        if text is not None:
            self._touch(key)
        return text

    def peek(self, key: str) -> str | None:
        """Like :meth:`get` but counter-silent — maintenance reads
        (inspect/gc/export) must not skew the popularity signal."""
        return self._read(validate_key(key))

    def put(self, key: str, text: str) -> None:
        self._write(validate_key(key), str(text))
        with self._lock:
            self.puts += 1
        self.sweep()

    def delete(self, key: str) -> bool:
        ok = self._delete(validate_key(key))
        if ok:
            with self._lock:
                self.deletes += 1
                self._access.pop(key, None)
        return ok

    def list(self, prefix: str = "") -> list:
        """Every stored key under `prefix`, sorted."""
        return sorted(k for k in self._keys() if k.startswith(prefix))

    def etag(self, key: str) -> str | None:
        """Content digest of the stored text (None when absent):
        version stamp for change detection and tiered promotion."""
        text = self._read(validate_key(key))
        return None if text is None else _etag_of(text)

    def sweep(self) -> int:
        """Apply the eviction policy now; returns entries evicted."""
        evicted = []
        now = self._clock()
        keys = self._keys()
        if self.policy.ttl_s is not None:
            for k in keys:
                if now - self._saved_at(k) > self.policy.ttl_s:
                    evicted.append(k)
        if self.policy.max_entries is not None:
            live = [k for k in keys if k not in evicted]
            excess = len(live) - self.policy.max_entries
            if excess > 0:
                live.sort(key=lambda k: (self._accessed_at(k), k))
                evicted.extend(live[:excess])
        for k in evicted:
            if self._delete(k):
                with self._lock:
                    self.evictions += 1
                    self._access.pop(k, None)
        return len(evicted)

    def access_counts(self) -> dict:
        """{key: get() hits} for this handle — the popularity feed."""
        with self._lock:
            return dict(self._access)

    def stats(self) -> dict:
        with self._lock:
            return {
                "backend": self.scheme,
                "uri": self.uri(),
                "entries": len(self._keys()),
                "hits": self.hits,
                "misses": self.misses,
                "puts": self.puts,
                "deletes": self.deletes,
                "evictions": self.evictions,
            }

    def path_for(self, key: str) -> Path | None:
        """The real filesystem path for `key` (dir backend only) —
        None when the backend has no per-key files."""
        return None

    def uri(self) -> str:
        raise NotImplementedError

    def flush(self) -> None:
        """Push deferred writes (tiered write-back); no-op elsewhere."""

    def close(self) -> None:
        """Release backend resources; handles stay constructible."""


class LocalDirBackend(StoreBackend):
    """Today's on-disk layout: one file per key under ``root``,
    written atomically so readers never see a torn document.
    Access recency for LRU is tracked in-memory per handle (files have
    no portable atime); ``saved_at`` is the file mtime, so TTL
    eviction agrees with what ``gc`` sees."""

    scheme = "dir"

    def __init__(self, root, *, policy=None, clock=time.time):
        super().__init__(policy=policy, clock=clock)
        self.root = Path(root)
        self._seen: dict = {}          # key -> last access (this handle)

    def _path(self, key: str) -> Path:
        return self.root / key

    def _read(self, key):
        p = self._path(key)
        try:
            return p.read_text()
        except OSError:
            return None

    def _write(self, key, text):
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".tmp")
        tmp.write_text(text)
        os.replace(tmp, p)             # readers never see a torn file

    def _delete(self, key):
        p = self._path(key)
        try:
            p.unlink()
        except OSError:
            return False
        self._seen.pop(key, None)
        return True

    def _keys(self):
        if not self.root.exists():
            return []
        return [
            p.relative_to(self.root).as_posix()
            for p in self.root.rglob("*.json")
            if p.is_file()
        ]

    def _saved_at(self, key):
        try:
            return self._path(key).stat().st_mtime
        except OSError:
            return 0.0

    def _accessed_at(self, key):
        return self._seen.get(key, self._saved_at(key))

    def _touch(self, key):
        self._seen[key] = self._clock()

    def prune_empty_dirs(self) -> None:
        if not self.root.exists():
            return
        for d in sorted(
            (p for p in self.root.rglob("*") if p.is_dir()),
            key=lambda p: len(p.parts),
            reverse=True,
        ):
            if not any(d.iterdir()):
                d.rmdir()

    def path_for(self, key: str) -> Path:
        return self.root if not key else self._path(validate_key(key))

    def uri(self) -> str:
        return f"dir://{self.root}"


class SqliteBackend(StoreBackend):
    """One shareable database file.  WAL journaling keeps readers
    unblocked while a writer commits — the property several hosts
    need when every one reads one shared cache.  Each
    operation opens its own short-lived connection (cross-thread and
    cross-process safe; the documents are small and rare enough that
    connection reuse would buy nothing)."""

    scheme = "sqlite"

    _SCHEMA = """
        CREATE TABLE IF NOT EXISTS entries (
            key         TEXT PRIMARY KEY,
            text        TEXT NOT NULL,
            etag        TEXT NOT NULL,
            saved_at    REAL NOT NULL,
            accessed_at REAL NOT NULL
        )
    """

    def __init__(self, path, *, policy=None, clock=time.time):
        super().__init__(policy=policy, clock=clock)
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self._connect() as con:
            con.execute("PRAGMA journal_mode=WAL")
            con.execute(self._SCHEMA)

    def _connect(self):
        return sqlite3.connect(self.path, timeout=10.0)

    def _read(self, key):
        with self._connect() as con:
            row = con.execute(
                "SELECT text FROM entries WHERE key = ?", (key,)
            ).fetchone()
        return None if row is None else row[0]

    def _write(self, key, text):
        now = self._clock()
        with self._connect() as con:
            con.execute(
                "INSERT INTO entries (key, text, etag, saved_at, "
                "accessed_at) VALUES (?, ?, ?, ?, ?) "
                "ON CONFLICT(key) DO UPDATE SET text = excluded.text, "
                "etag = excluded.etag, saved_at = excluded.saved_at, "
                "accessed_at = excluded.accessed_at",
                (key, text, _etag_of(text), now, now),
            )

    def _delete(self, key):
        with self._connect() as con:
            cur = con.execute(
                "DELETE FROM entries WHERE key = ?", (key,)
            )
        return cur.rowcount > 0

    def _keys(self):
        with self._connect() as con:
            return [
                r[0] for r in con.execute("SELECT key FROM entries")
            ]

    def _saved_at(self, key):
        with self._connect() as con:
            row = con.execute(
                "SELECT saved_at FROM entries WHERE key = ?", (key,)
            ).fetchone()
        return 0.0 if row is None else float(row[0])

    def _accessed_at(self, key):
        with self._connect() as con:
            row = con.execute(
                "SELECT accessed_at FROM entries WHERE key = ?", (key,)
            ).fetchone()
        return 0.0 if row is None else float(row[0])

    def _touch(self, key):
        with self._connect() as con:
            con.execute(
                "UPDATE entries SET accessed_at = ? WHERE key = ?",
                (self._clock(), key),
            )

    def etag(self, key: str) -> str | None:
        with self._connect() as con:
            row = con.execute(
                "SELECT etag FROM entries WHERE key = ?",
                (validate_key(key),),
            ).fetchone()
        return None if row is None else row[0]

    def uri(self) -> str:
        return f"sqlite://{self.path}"


class MemoryBackend(StoreBackend):
    """In-process dict; ``mem://<name>`` URIs share one instance per
    name (module registry), so several handles in one process get a
    shared cache with zero filesystem."""

    scheme = "mem"

    def __init__(self, name: str = "", *, policy=None, clock=time.time):
        super().__init__(policy=policy, clock=clock)
        self.name = name
        self._data: dict = {}          # key -> (text, saved, accessed)

    def _read(self, key):
        row = self._data.get(key)
        return None if row is None else row[0]

    def _write(self, key, text):
        now = self._clock()
        self._data[key] = (text, now, now)

    def _delete(self, key):
        return self._data.pop(key, None) is not None

    def _keys(self):
        return list(self._data)

    def _saved_at(self, key):
        row = self._data.get(key)
        return 0.0 if row is None else row[1]

    def _accessed_at(self, key):
        row = self._data.get(key)
        return 0.0 if row is None else row[2]

    def _touch(self, key):
        row = self._data.get(key)
        if row is not None:
            self._data[key] = (row[0], row[1], self._clock())

    def uri(self) -> str:
        return f"mem://{self.name}"


class TieredBackend(StoreBackend):
    """Read-through composition: a host-local `front` cache over a
    shared `back`.  ``get`` serves front hits without touching the
    back and promotes back-tier hits into the front; ``put`` writes
    through to both unless ``write_back=True``, which journals dirty
    keys locally until :meth:`flush` pushes them (an ETag check skips
    keys the back already holds verbatim).  ``flush_interval_s``
    declares the tier's flush cadence: the backend itself stays
    passive (no threads here), but
    ``CacheService.enqueue_flush`` reads it to drive :meth:`flush`
    as a periodic ``WorkQueue`` job, bounding how stale the shared
    back tier can get.  The tier's own hit/miss
    counters measure front effectiveness; :meth:`stats` nests both
    tiers' counters."""

    scheme = "tiered"

    def __init__(self, front: StoreBackend, back: StoreBackend, *,
                 write_back: bool = False, flush_interval_s=None,
                 policy=None, clock=time.time):
        super().__init__(policy=policy, clock=clock)
        if flush_interval_s is not None:
            flush_interval_s = float(flush_interval_s)
            if flush_interval_s <= 0:
                raise ValueError("flush_interval_s must be positive")
            if not write_back:
                raise ValueError(
                    "flush_interval_s without write_back=True is "
                    "meaningless: write-through tiers are never dirty"
                )
        self.front = front
        self.back = back
        self.write_back = write_back
        self.flush_interval_s = flush_interval_s
        self._dirty: set = set()

    def _read(self, key):
        text = self.front.peek(key)
        if text is not None:
            return text
        text = self.back.peek(key)
        if text is not None:
            self.front.put(key, text)   # promote (read-through)
        return text

    def _write(self, key, text):
        self.front.put(key, text)
        if self.write_back:
            with self._lock:
                self._dirty.add(key)
        else:
            self.back.put(key, text)

    def _delete(self, key):
        with self._lock:
            self._dirty.discard(key)
        f = self.front.delete(key)
        b = self.back.delete(key)
        return f or b

    def _keys(self):
        return list(set(self.front.list()) | set(self.back.list()))

    def _saved_at(self, key):
        return max(self.front._saved_at(key), self.back._saved_at(key))

    def _accessed_at(self, key):
        return max(
            self.front._accessed_at(key), self.back._accessed_at(key)
        )

    def etag(self, key: str) -> str | None:
        return (
            self.front.etag(key)
            if self.front.peek(key) is not None
            else self.back.etag(key)
        )

    def path_for(self, key: str) -> Path | None:
        return self.front.path_for(key)

    def flush(self) -> int:
        """Push every dirty key to the back tier; returns pushes
        performed (ETag-identical keys are skipped, not pushed)."""
        with self._lock:
            dirty, self._dirty = self._dirty, set()
        pushed = 0
        for key in sorted(dirty):
            text = self.front.peek(key)
            if text is None:
                continue               # written then deleted
            if self.back.etag(key) == _etag_of(text):
                continue
            self.back.put(key, text)
            pushed += 1
        return pushed

    def dirty(self) -> tuple:
        with self._lock:
            return tuple(sorted(self._dirty))

    def stats(self) -> dict:
        out = super().stats()
        out["pending_write_back"] = len(self._dirty)
        out["flush_interval_s"] = self.flush_interval_s
        out["front"] = self.front.stats()
        out["back"] = self.back.stats()
        return out

    def uri(self) -> str:
        return f"tiered://{self.front.uri()}|{self.back.uri()}"


_MEM_REGISTRY: dict = {}
_MEM_LOCK = threading.Lock()


def parse_backend(spec, *, policy: EvictionPolicy | None = None
                  ) -> StoreBackend:
    """Resolve a backend from a URI, path, or backend instance.

    ``dir://path`` / bare path / :class:`~pathlib.Path` → dir backend;
    ``sqlite://path`` → sqlite; ``mem://name`` → the process-shared
    memory backend for `name` (an empty name is a fresh private one).
    A :class:`StoreBackend` instance passes through unchanged."""
    if isinstance(spec, StoreBackend):
        return spec
    if isinstance(spec, Path):
        return LocalDirBackend(spec, policy=policy)
    if not isinstance(spec, str):
        raise TypeError(
            f"cannot resolve a store backend from {type(spec).__name__}"
        )
    if spec.startswith("mem://"):
        name = spec[len("mem://"):]
        if not name:
            return MemoryBackend(policy=policy)
        with _MEM_LOCK:
            if name not in _MEM_REGISTRY:
                _MEM_REGISTRY[name] = MemoryBackend(name, policy=policy)
            return _MEM_REGISTRY[name]
    if spec.startswith("sqlite://"):
        path = spec[len("sqlite://"):]
        if not path:
            raise ValueError("sqlite:// needs a database path")
        return SqliteBackend(path, policy=policy)
    if spec.startswith("dir://"):
        path = spec[len("dir://"):]
        if not path:
            raise ValueError("dir:// needs a directory path")
        return LocalDirBackend(path, policy=policy)
    if "://" in spec:
        raise ValueError(
            f"unknown store backend URI {spec!r}; expected dir://, "
            "sqlite:// or mem://"
        )
    return LocalDirBackend(spec, policy=policy)
