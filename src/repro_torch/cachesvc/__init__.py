"""Shared profile/mapping cache service, the port of the JAX package's
``repro.cachesvc``.

Three layers, each usable alone:

* :mod:`repro_torch.cachesvc.backends` — pluggable keyed-text storage behind
  :class:`~repro_torch.store.ProfileStore` (``dir://`` bit-compatible with
  the JAX package's layout, ``sqlite://`` shared single-file, ``mem://``
  in-process, tiered read-through composition, ETags, LRU/TTL
  eviction, hit/miss/access counters).
* :mod:`repro_torch.cachesvc.workqueue` — a deduped, retrying async work
  queue (`WorkQueue` + `WorkerPool`) with journaled
  :class:`~repro_torch.cachesvc.workqueue.JobRecord` entries.
* :mod:`repro_torch.cachesvc.service` / :mod:`repro_torch.cachesvc.jobs` — the
  background jobs (``prewarm`` / ``refit`` / ``explore`` /
  ``flush``) and the
  :class:`~repro_torch.cachesvc.service.CacheService` that schedules them
  off the serving path.

Only the backend layer is imported eagerly: :mod:`repro_torch.store` depends
on it, while the service layer depends on :mod:`repro_torch.store` — lazy
attribute access keeps the cycle open.
"""

from repro_torch.cachesvc.backends import (
    EvictionPolicy,
    LocalDirBackend,
    MemoryBackend,
    SqliteBackend,
    StoreBackend,
    TieredBackend,
    parse_backend,
)

_LAZY = {
    "JobRecord": "repro_torch.cachesvc.workqueue",
    "WorkQueue": "repro_torch.cachesvc.workqueue",
    "WorkerPool": "repro_torch.cachesvc.workqueue",
    "coverage_report": "repro_torch.cachesvc.jobs",
    "execution_counts": "repro_torch.cachesvc.jobs",
    "explore_once": "repro_torch.cachesvc.jobs",
    "flush_once": "repro_torch.cachesvc.jobs",
    "prewarm_once": "repro_torch.cachesvc.jobs",
    "refit_once": "repro_torch.cachesvc.jobs",
    "CacheService": "repro_torch.cachesvc.service",
}

__all__ = [
    "EvictionPolicy",
    "LocalDirBackend",
    "MemoryBackend",
    "SqliteBackend",
    "StoreBackend",
    "TieredBackend",
    "parse_backend",
    *_LAZY,
]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
