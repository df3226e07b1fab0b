"""Async work queue for background cache jobs — deduped, retried,
journaled.

The cache service's jobs (``prewarm`` / ``refit`` / ``explore``) are
**idempotent**: each is keyed like the store entry it materializes,
re-running one converges to the same artifact, and a crash mid-job
loses nothing but the attempt.  That contract is what makes the queue
simple and safe:

* **dedupe** — :meth:`WorkQueue.submit` refuses a (kind, key) that is
  already queued or running, so a popularity spike enqueues one
  prewarm, not fifty;
* **delay + periodic jobs** — ``submit(..., delay_s=, repeat_s=)``
  defers the first run and, with ``repeat_s``, re-enqueues a fresh
  attempt one period after each completion (the timed write-back
  flush rides this) until :meth:`WorkQueue.cancel`;
* **retry with exponential backoff** — a failing job is re-queued with
  ``backoff_s * 2**(attempt-1)`` delay until ``max_attempts``, then
  journaled as failed (never silently dropped, never retried forever);
* **journal** — every *finished* job appends an immutable
  :class:`JobRecord`, so operators can audit what background work
  ran, when, with what outcome.

Time is injected (``clock``) and sleeping is injected (``drain``'s
``sleep=``), so tests drive retry/backoff with a fake clock —
``drain(sleep=clock.advance)`` passes virtual time between attempts
with **zero real sleeps**.

:class:`WorkQueue` alone is a synchronous scheduler
(:meth:`~WorkQueue.run_pending` / :meth:`~WorkQueue.drain` — fully
deterministic, what tests and the bench use).  :class:`WorkerPool`
adds real daemon threads popping the same queue for deployments that
want background work genuinely off the serving thread.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable


@dataclasses.dataclass(frozen=True)
class JobRecord:
    """One finished background job, as the journal reports it."""

    seq: int
    kind: str
    key: str
    status: str                  # "done" | "failed"
    attempts: int
    enqueued_s: float
    finished_s: float
    result: dict | None = None
    error: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _Job:
    kind: str
    key: str
    fn: Callable
    enqueued_s: float
    due_s: float
    attempts: int = 0
    repeat_s: float | None = None    # periodic job: re-enqueue period

    @property
    def ident(self) -> tuple:
        return (self.kind, self.key)


class WorkQueue:
    """Deduped delay queue of idempotent jobs.

    ``submit(kind, key, fn)`` enqueues ``fn()`` under the job identity
    ``(kind, key)``; a duplicate of a queued/running identity is
    refused (returns False).  Jobs run when *popped* — by
    :meth:`run_pending` / :meth:`drain` on the calling thread, or by a
    :class:`WorkerPool`.  A job that raises is retried with
    exponential backoff up to ``max_attempts``, then journaled as
    failed.  ``fn``'s return value (a JSON-able dict or None) lands in
    the :class:`JobRecord`.
    """

    def __init__(
        self,
        *,
        clock: Callable[[], float] = time.monotonic,
        max_attempts: int = 3,
        backoff_s: float = 0.05,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if backoff_s < 0:
            raise ValueError("backoff_s must be >= 0")
        self.clock = clock
        self.max_attempts = max_attempts
        self.backoff_s = backoff_s
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queued: list = []
        self._running: set = set()
        self._cancelled: set = set()
        self._journal: list = []
        self._seq = 0
        self.submitted = 0
        self.deduped = 0
        self.retries = 0

    # -- producer side -----------------------------------------------
    def submit(
        self,
        kind: str,
        key: str,
        fn: Callable,
        *,
        delay_s: float = 0.0,
        repeat_s: float | None = None,
    ) -> bool:
        """Enqueue ``fn`` as job (kind, key); False when that identity
        is already queued or running (idempotent jobs make the newer
        submission redundant, not lost).

        ``delay_s`` defers the first run.  ``repeat_s`` makes the job
        **periodic**: each completion (success *or* final failure —
        a timer must not die because one tick failed) re-enqueues a
        fresh attempt ``repeat_s`` after it finishes, until
        :meth:`cancel`.  Periodic re-enqueues happen at the queue
        level precisely because this dedupe would refuse a job
        resubmitting itself from inside its own ``fn`` (its identity
        is still marked running there)."""
        if delay_s < 0:
            raise ValueError("delay_s must be >= 0")
        if repeat_s is not None and repeat_s <= 0:
            raise ValueError("repeat_s must be positive")
        ident = (str(kind), str(key))
        with self._cv:
            live = {j.ident for j in self._queued} | self._running
            if ident in live:
                self.deduped += 1
                return False
            self._cancelled.discard(ident)
            now = self.clock()
            self._queued.append(
                _Job(
                    ident[0], ident[1], fn, enqueued_s=now,
                    due_s=now + delay_s, repeat_s=repeat_s,
                )
            )
            self.submitted += 1
            self._cv.notify()
            return True

    def cancel(self, kind: str, key: str) -> bool:
        """Drop job (kind, key): dequeue it if queued; if currently
        running, let the attempt finish but suppress a periodic
        re-enqueue.  Returns True when the identity was live."""
        ident = (str(kind), str(key))
        with self._cv:
            before = len(self._queued)
            self._queued = [j for j in self._queued if j.ident != ident]
            if len(self._queued) != before:
                return True
            if ident in self._running:
                self._cancelled.add(ident)
                return True
            return False

    # -- consumer side -----------------------------------------------
    def _pop_due(self):
        """(internal, lock held) the first due job, marked running."""
        now = self.clock()
        for i, job in enumerate(self._queued):
            if job.due_s <= now:
                self._running.add(job.ident)
                return self._queued.pop(i)
        return None

    def _record(self, job: _Job, status: str, result, error: str):
        self._journal.append(
            JobRecord(
                seq=self._seq,
                kind=job.kind,
                key=job.key,
                status=status,
                attempts=job.attempts,
                enqueued_s=job.enqueued_s,
                finished_s=self.clock(),
                result=result,
                error=error,
            )
        )
        self._seq += 1

    def _reschedule(self, job: _Job) -> None:
        """(lock held) re-enqueue a finished periodic job one period
        out, as a fresh attempt — unless it was cancelled mid-run."""
        if job.repeat_s is None:
            return
        if job.ident in self._cancelled:
            self._cancelled.discard(job.ident)
            return
        now = self.clock()
        self._queued.append(
            _Job(
                job.kind, job.key, job.fn, enqueued_s=now,
                due_s=now + job.repeat_s, repeat_s=job.repeat_s,
            )
        )

    def _execute(self, job: _Job) -> None:
        """Run one popped job; journal or re-queue under the lock."""
        job.attempts += 1
        try:
            result = job.fn()
        except Exception as exc:  # noqa: BLE001 — journaled, not lost
            with self._cv:
                self._running.discard(job.ident)
                if job.attempts >= self.max_attempts:
                    self._record(
                        job, "failed", None,
                        f"{type(exc).__name__}: {exc}",
                    )
                    self._reschedule(job)
                else:
                    self.retries += 1
                    job.due_s = self.clock() + self.backoff_s * (
                        2 ** (job.attempts - 1)
                    )
                    self._queued.append(job)
                self._cv.notify_all()
            return
        with self._cv:
            self._running.discard(job.ident)
            self._record(
                job, "done",
                result if isinstance(result, dict) else None, "",
            )
            self._reschedule(job)
            self._cv.notify_all()

    def run_pending(self) -> int:
        """Run every currently-due job on this thread (one pass —
        backoff-delayed retries stay queued); returns jobs run."""
        ran = 0
        while True:
            with self._cv:
                job = self._pop_due()
            if job is None:
                return ran
            self._execute(job)
            ran += 1

    def drain(self, *, sleep: Callable[[float], None] | None = None) -> int:
        """Run until every **one-shot** job (including its backoff
        retries) has finished, sleeping to the next deadline between
        passes; periodic jobs never make a queue "dirty", or a single
        ``repeat_s`` timer would make drain spin forever.  Inject
        ``sleep=fake_clock.advance`` in tests: retries then experience
        full virtual backoff with zero real sleeping.  Returns total
        jobs run."""
        sleep = time.sleep if sleep is None else sleep
        ran = 0
        while True:
            ran += self.run_pending()
            with self._cv:
                oneshot = [
                    j for j in self._queued if j.repeat_s is None
                ]
                if not oneshot:
                    return ran
                delay = max(
                    0.0,
                    min(j.due_s for j in oneshot) - self.clock(),
                )
            # max() guards a clock that only moves when told to: a
            # zero-delay sleep must still let it make progress
            sleep(max(delay, 1e-9))

    def next_due_s(self) -> float | None:
        """Seconds until the earliest queued job is due (0 when due
        now); None when nothing is queued."""
        with self._cv:
            if not self._queued:
                return None
            return max(
                0.0, min(j.due_s for j in self._queued) - self.clock()
            )

    # -- introspection -----------------------------------------------
    def pending(self) -> int:
        with self._cv:
            return len(self._queued) + len(self._running)

    @property
    def journal(self) -> tuple:
        with self._cv:
            return tuple(self._journal)

    def stats(self) -> dict:
        with self._cv:
            done = sum(1 for r in self._journal if r.status == "done")
            failed = len(self._journal) - done
            return {
                "queued": len(self._queued),
                "running": len(self._running),
                "repeating": sum(
                    1 for j in self._queued if j.repeat_s is not None
                ),
                "submitted": self.submitted,
                "deduped": self.deduped,
                "retries": self.retries,
                "done": done,
                "failed": failed,
            }


class WorkerPool:
    """Daemon threads draining a :class:`WorkQueue` in the background.

    Start with :meth:`start`; :meth:`join_idle` blocks (with real
    time) until the queue is momentarily empty — the synchronization
    tests and shutdown paths need; :meth:`stop` halts the loops and
    joins the threads.  The pool adds no scheduling policy of its own:
    dedupe/backoff/journal all live in the queue, so synchronous and
    threaded execution are behaviorally identical.
    """

    def __init__(self, queue: WorkQueue, *, n_workers: int = 2,
                 poll_s: float = 0.02):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.queue = queue
        self.n_workers = n_workers
        self.poll_s = poll_s
        self._stop = threading.Event()
        self._threads: list = []

    def start(self) -> "WorkerPool":
        if self._threads:
            raise RuntimeError("worker pool already started")
        for i in range(self.n_workers):
            t = threading.Thread(
                target=self._loop, name=f"cachesvc-worker-{i}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
        return self

    def _loop(self) -> None:
        q = self.queue
        while not self._stop.is_set():
            with q._cv:
                job = q._pop_due()
                if job is None:
                    q._cv.wait(timeout=self.poll_s)
                    continue
            q._execute(job)

    def join_idle(self, timeout: float = 5.0) -> bool:
        """Wait until no one-shot work is queued and nothing is
        running (True) or `timeout` real seconds elapse (False).
        Dormant periodic jobs don't count — a flush timer would
        otherwise make the pool permanently non-idle."""
        deadline = time.monotonic() + timeout
        q = self.queue
        with q._cv:
            while (
                any(j.repeat_s is None for j in q._queued) or q._running
            ):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                q._cv.wait(timeout=min(remaining, self.poll_s))
        return True

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        with self.queue._cv:
            self.queue._cv.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)
        self._threads = []

    @property
    def alive(self) -> int:
        return sum(1 for t in self._threads if t.is_alive())
