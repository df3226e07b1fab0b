"""Dynamic micro-batching for the serving engine.

Single-example requests are coalesced into micro-batches under two
knobs: ``max_batch`` (close a batch as soon as it is full) and
``max_wait_s`` (close a partial batch once its oldest request has
waited long enough).  Partial batches are **padded up to a profiled
batch size** so every micro-batch the pipeline executes is one the
:class:`~repro_torch.core.profiler.ProfileTable` actually measured — the
mapper's expected times (and the proper-batch-size choice itself) stay
valid for the traffic the engine serves.  Pad rows are zeros and their
outputs are discarded before responses complete.

The clock is injectable so coalescing deadlines are deterministic
under test.

**Thread-safety.**  :meth:`MicroBatcher.submit` may be called from
any number of threads concurrently — the queue is lock-protected and
FIFO by submission timestamp (the clock is read under the lock, so
queue order and ``submit_t`` order agree), and each request takes its
``id``, a sequence number, under the same lock: a micro-batch is a run
of consecutive ids.  ``next_batch``/``drain``
are also lock-safe (two drainers never pop the same request), but the
serving engine's step path is single-threaded by contract — see
``repro_torch.serving.engine``.  The fleet router depends on exactly
this split: client threads submit, one dispatch thread drains.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Sequence

import numpy as np

from repro_torch import spans


@dataclasses.dataclass
class Request:
    """One in-flight example.  ``wait()`` blocks until the engine
    completes it; ``submit_t``/``done_t`` bound its serving latency;
    ``id`` is its batcher's submit sequence number."""

    x: np.ndarray
    submit_t: float
    id: int = -1
    result: np.ndarray | None = None
    error: BaseException | None = None
    done_t: float | None = None
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False
    )

    def complete(self, result: np.ndarray, now: float) -> None:
        self.result = result
        self.done_t = now
        self._done.set()

    def fail(self, error: BaseException, now: float) -> None:
        """Terminal error path: a request popped off the queue must
        never be silently dropped — waiters get the exception."""
        self.error = error
        self.done_t = now
        self._done.set()

    def wait(self, timeout: float | None = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError("request not completed")
        if self.error is not None:
            raise self.error
        return self.result

    @property
    def latency_s(self) -> float:
        if self.done_t is None:
            raise ValueError("request not completed")
        return self.done_t - self.submit_t


@dataclasses.dataclass(frozen=True)
class MicroBatch:
    """`requests` stacked into `x`, zero-padded from ``n_real`` rows up
    to a profiled batch size."""

    requests: tuple
    x: np.ndarray
    n_real: int

    @property
    def padded_size(self) -> int:
        return self.x.shape[0]


def pad_to(n: int, allowed: Sequence[int] | None) -> int:
    """Smallest allowed batch size that fits ``n`` requests (``n``
    itself when ``allowed`` is None — an empty sequence is an error,
    not an absence of constraint)."""
    if n <= 0:
        raise ValueError("cannot pad an empty batch")
    if allowed is None:
        return n
    if not allowed:
        raise ValueError("allowed batch sizes must be non-empty")
    fits = [s for s in allowed if s >= n]
    if not fits:
        raise ValueError(
            f"batch of {n} exceeds every allowed size {tuple(allowed)}"
        )
    return min(fits)


class MicroBatcher:
    """Thread-safe FIFO request queue with deadline-based coalescing."""

    def __init__(
        self,
        *,
        max_batch: int,
        max_wait_s: float = 2e-3,
        allowed_batch_sizes: Sequence[int] | None = None,
        clock=time.monotonic,
    ):
        if max_batch <= 0:
            raise ValueError("max_batch must be positive")
        if allowed_batch_sizes is not None:
            allowed_batch_sizes = tuple(sorted(allowed_batch_sizes))
            if not allowed_batch_sizes:
                raise ValueError(
                    "allowed_batch_sizes must be non-empty when given"
                )
            if max_batch > allowed_batch_sizes[-1]:
                raise ValueError(
                    f"max_batch {max_batch} exceeds the largest profiled "
                    f"batch size {allowed_batch_sizes[-1]}"
                )
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.allowed_batch_sizes = allowed_batch_sizes
        self._clock = clock
        self._lock = threading.Lock()
        self._queue: deque = deque()
        self._ids = itertools.count()   # each Request's id

    def submit(self, x) -> Request:
        x = np.asarray(x)
        # the clock is read *inside* the lock: two threads racing
        # submit() must enqueue in timestamp order, or ready()'s
        # oldest-request age check could read a non-head timestamp and
        # a batch's coalescing deadline would jitter by the race window
        with self._lock:
            # positional: the dataclass's keyword path costs more
            req = Request(x, self._clock(), next(self._ids))
            self._queue.append(req)
        return req

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def ready(self) -> bool:
        """A batch is ready when it is full, or its oldest request has
        aged past ``max_wait_s``."""
        with self._lock:
            if not self._queue:
                return False
            if len(self._queue) >= self.max_batch:
                return True
            return (
                self._clock() - self._queue[0].submit_t >= self.max_wait_s
            )

    def next_batch(self, *, force: bool = False) -> MicroBatch | None:
        """Pop up to ``max_batch`` requests into a padded MicroBatch;
        None when nothing is ready (``force`` flushes a partial batch
        regardless of its age).  Recording, each micro-batch is a
        ``batcher.drain`` span: first request id, real rows."""
        if not force and not self.ready():
            return None
        sp = spans.open("batcher.drain") if spans.on else None
        with self._lock:
            if not self._queue:
                if sp is not None:
                    spans.discard(sp)
                return None
            take = min(len(self._queue), self.max_batch)
            reqs = tuple(self._queue.popleft() for _ in range(take))
        xs = np.stack([r.x for r in reqs])
        target = pad_to(len(reqs), self.allowed_batch_sizes)
        if target > len(reqs):
            pad = np.zeros((target - len(reqs),) + xs.shape[1:], xs.dtype)
            xs = np.concatenate([xs, pad])
        if sp is not None:
            spans.close(sp, reqs[0].id, len(reqs))
        return MicroBatch(requests=reqs, x=xs, n_real=len(reqs))

    def drain(self, *, force: bool = True) -> list:
        """All currently-poppable micro-batches, oldest first."""
        batches = []
        while (mb := self.next_batch(force=force)) is not None:
            batches.append(mb)
        return batches

    def migrate_to(self, other: "MicroBatcher") -> int:
        """Move every *queued* (not yet dispatched) request into
        `other`'s queue, preserving submit-timestamp order against
        requests already waiting there.  The Request objects move
        as-is — callers holding them block on the same event and
        complete on the destination's engine.  Returns requests moved.

        Locks are taken strictly sequentially (drain self fully, then
        lock other), never nested, so concurrent submitters on either
        batcher cannot deadlock against a migration."""
        if other is self:
            return 0
        with self._lock:
            moving = list(self._queue)
            self._queue.clear()
        if not moving:
            return 0
        with other._lock:
            merged = sorted(
                list(other._queue) + moving, key=lambda r: r.submit_t
            )
            other._queue.clear()
            other._queue.extend(merged)
        return len(moving)
