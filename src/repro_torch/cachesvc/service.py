"""`CacheService` — the shared cache's control plane.

Glues the three layers together: a :class:`~repro_torch.store.ProfileStore`
(over any backend), a :class:`~repro_torch.cachesvc.workqueue.WorkQueue`,
and the job bodies in :mod:`repro_torch.cachesvc.jobs`.  A service instance
owns a *catalog* of registered models and turns operator intents into
deduped, journaled background jobs:

* :meth:`enqueue_prewarm` / :meth:`prewarm_popular` — materialize
  profile + mapping for a key ahead of demand; ``prewarm_popular``
  ranks the catalog by the backend's per-key access counters (every
  serving-path ``load_*`` feeds them), so the keys real traffic asks
  for most are warmed first.
* :meth:`enqueue_refit` — retrain the learned estimators when enough
  new training rows accumulated (``jobs.refit_once``).
* :meth:`enqueue_explore` — re-profile never-or-stale-executed
  placements from a coverage report and fold corrections back
  (``jobs.explore_once``), closing the exploration residual off the
  hot path; ``sweep="frontier"`` re-measures every stale candidate,
  not only the cheapest.
* :meth:`enqueue_flush` — push a write-back tier's dirty keys to the
  shared back tier, one-shot or (with a ``flush_interval_s``)
  periodic via the queue's ``repeat_s`` timer.

Jobs are **keyed like the store entries they materialize** (the
profile/mapping/predictor key strings), so queue dedupe and store
idempotency line up: the same intent enqueued twice converges to one
job and one artifact.  Run jobs synchronously
(:meth:`run_pending` / :meth:`drain` — deterministic, test-friendly)
or start a :meth:`workers` pool to take them genuinely off-thread.
"""

from __future__ import annotations

import time
from typing import Callable, Mapping, Sequence

from repro_torch.cachesvc import jobs as _jobs
from repro_torch.cachesvc.workqueue import WorkerPool, WorkQueue


class CacheService:
    def __init__(
        self,
        store,
        *,
        profile_fn: Callable | None = None,
        measure_fn: Callable | None = None,
        batch_sizes: Sequence[int] = (4,),
        policy: str = "dp",
        configs: Sequence[str] | None = None,
        refit_min_new_rows: int = 8,
        explore_min_count: int = 1,
        max_attempts: int = 3,
        backoff_s: float = 0.05,
        clock: Callable[[], float] = time.monotonic,
    ):
        """``store`` is a :class:`~repro_torch.store.ProfileStore`, a backend
        URI, or a backend instance.  ``profile_fn(model, packed, *,
        batch_sizes)`` powers prewarm; ``measure_fn(layer, config,
        batch) -> seconds`` powers explore — each optional until the
        matching job kind is enqueued."""
        from repro_torch.store import ProfileStore

        self.store = (
            store if isinstance(store, ProfileStore)
            else ProfileStore(store)
        )
        self.profile_fn = profile_fn
        self.measure_fn = measure_fn
        self.batch_sizes = tuple(batch_sizes)
        self.policy = policy
        self.configs = configs
        self.refit_min_new_rows = refit_min_new_rows
        self.explore_min_count = explore_min_count
        self.queue = WorkQueue(
            clock=clock, max_attempts=max_attempts, backoff_s=backoff_s
        )
        self._catalog: dict = {}       # name -> (model, packed_params)

    # -- catalog -----------------------------------------------------
    def register(self, name: str, model, packed_params) -> None:
        """Make (model, params) known to the service so prewarm jobs
        can be enqueued by name (e.g. by popularity ranking)."""
        self._catalog[str(name)] = (model, packed_params)

    @property
    def catalog(self) -> tuple:
        return tuple(sorted(self._catalog))

    def _sig(self, name: str) -> str:
        from repro_torch.store import model_signature

        model, _ = self._catalog[name]
        return model_signature(model)

    # -- prewarm -----------------------------------------------------
    def enqueue_prewarm(
        self, name: str, *, batch_sizes: Sequence[int] | None = None
    ) -> bool:
        """Queue a prewarm for a registered model; False when the same
        key is already queued/running."""
        if self.profile_fn is None:
            raise ValueError("prewarm needs a profile_fn")
        model, packed = self._catalog[str(name)]
        sizes = tuple(
            batch_sizes if batch_sizes is not None else self.batch_sizes
        )
        key = self.store.profile_key(self._sig(str(name)), sizes)
        return self.queue.submit(
            "prewarm",
            key,
            lambda: _jobs.prewarm_once(
                self.store, model, packed,
                profile_fn=self.profile_fn,
                batch_sizes=sizes,
                policy=self.policy,
                configs=self.configs,
            ),
        )

    def popularity(self) -> dict:
        """{registered name: backend access count} — how often
        serving-path loads touched each model's keys.  The ranking
        signal for :meth:`prewarm_popular`."""
        counts = self.store.backend.access_counts()
        out = {}
        for name in self._catalog:
            marker = f"/{self._sig(name)}-r"
            out[name] = sum(
                n for key, n in counts.items() if marker in key
            )
        return out

    def prewarm_popular(self, *, top: int = 4) -> int:
        """Enqueue prewarms for the `top` most-accessed registered
        models (most popular first; ties alphabetical); returns jobs
        actually enqueued after dedupe."""
        ranked = sorted(
            self.popularity().items(), key=lambda kv: (-kv[1], kv[0])
        )
        enqueued = 0
        for name, _count in ranked[: max(0, int(top))]:
            if self.enqueue_prewarm(name):
                enqueued += 1
        return enqueued

    # -- refit -------------------------------------------------------
    def enqueue_refit(self, *, observations=None) -> bool:
        """Queue an estimator refit (predictor + optional interference
        law from ``observations=(ledger, expected_step_s)``)."""
        key = self.store._predictor_key()
        return self.queue.submit(
            "refit",
            key,
            lambda: _jobs.refit_once(
                self.store,
                min_new_rows=self.refit_min_new_rows,
                observations=observations,
            ),
        )

    # -- explore -----------------------------------------------------
    def enqueue_explore(
        self,
        name: str,
        table,
        *,
        batch: int,
        counts: Mapping,
        measure_fn: Callable | None = None,
        sweep: str = "cheapest",
    ) -> bool:
        """Queue an exploration pass for a registered model: `counts`
        is :func:`~repro_torch.cachesvc.jobs.execution_counts` output from
        the serving tier; stale placements get re-measured off the hot
        path and a strictly-better remap is persisted.
        ``sweep="frontier"`` re-measures *every* stale candidate row
        (per-candidate folding) instead of the cheapest only."""
        measure = measure_fn or self.measure_fn
        if measure is None:
            raise ValueError("explore needs a measure_fn")
        model, _ = self._catalog[str(name)]
        key = self.store.mapping_key(
            self._sig(str(name)), self.policy, batch
        )
        counts = dict(counts)
        return self.queue.submit(
            "explore",
            key,
            lambda: _jobs.explore_once(
                self.store, model, table,
                batch=batch,
                counts=counts,
                measure_fn=measure,
                policy=self.policy,
                min_count=self.explore_min_count,
                sweep=sweep,
            ),
        )

    # -- flush -------------------------------------------------------
    def enqueue_flush(self, backend=None, *, interval_s=None) -> bool:
        """Queue a write-back flush of `backend` (default: this
        store's backend; it must expose ``flush()``/``dirty()``, i.e.
        be a write-back :class:`~repro_torch.cachesvc.TieredBackend`).

        With an interval — explicit ``interval_s``, else the
        backend's own ``flush_interval_s`` — the job is **periodic**:
        it re-runs every interval until ``queue.cancel("flush",
        backend.uri())``, so dirty keys reach the shared back tier on
        a timer instead of waiting for an explicit flush.  Without
        either, it is a one-shot flush.  Keyed by the backend URI:
        one timer per tier, however many times this is called."""
        backend = backend if backend is not None else self.store.backend
        # every backend inherits a no-op flush(); only the tiered
        # write-back journal exposes dirty(), so gate on that
        if not hasattr(backend, "dirty"):
            raise ValueError(
                f"backend {backend.uri()!r} has no write-back journal; "
                "timed flushes need a write-back TieredBackend"
            )
        interval = (
            interval_s if interval_s is not None
            else getattr(backend, "flush_interval_s", None)
        )
        return self.queue.submit(
            "flush",
            backend.uri(),
            lambda: _jobs.flush_once(backend),
            delay_s=0.0 if interval is None else float(interval),
            repeat_s=None if interval is None else float(interval),
        )

    # -- execution ---------------------------------------------------
    def run_pending(self) -> int:
        return self.queue.run_pending()

    def drain(self, *, sleep=None) -> int:
        return self.queue.drain(sleep=sleep)

    def workers(self, n: int = 2, **kwargs) -> WorkerPool:
        """A started :class:`WorkerPool` over this service's queue."""
        return WorkerPool(self.queue, n_workers=n, **kwargs).start()

    # -- introspection -----------------------------------------------
    @property
    def journal(self) -> tuple:
        return self.queue.journal

    def stats(self) -> dict:
        return {
            "store": self.store.stats(),
            "queue": self.queue.stats(),
        }
