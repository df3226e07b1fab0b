"""The port's span recorder: what the host was doing, and when, on the
clock the device trace is tied to.

One recorder per process, off by default.  A site in the program reads

    sp = spans.open("pipeline.stage", i) if spans.on else None
    ...                                   # the work the span names
    if sp is not None:
        spans.close(sp)

so that, off, a site costs one attribute test: no call, no clock read,
no allocation.  On, ``open`` reads ``time.monotonic_ns()`` (the clock of
``MicroBatcher``'s default ``submit_t`` and of ``time.monotonic``, to
which a profiler trace is tied by its primer kernels), and the span's
parent is the innermost span still open on the same thread; ``close``
is called on the thread that opened the span.  Closing a span also takes
off the thread's stack any span opened inside it that an exception left
open (it keeps end -1), so one failed step does not misparent the next.

Each span carries two integer attributes ``a`` and ``b`` (request id,
rows, micro-batch, segment index: each site says which).  Each
thread records into its own columns of machine integers, so recording
takes no lock and makes no object the garbage collector tracks: turning
it on does not make collections longer.  Spans stay in memory until
:func:`take`, which returns them as columns and forgets them.  While the
recorder is on, every collection of the garbage collector is a ``gc``
span (``a`` = its generation) on the thread that triggered it.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time
from array import array

import numpy as np

on = False          # the one attribute every site tests

_monotonic_ns = time.monotonic_ns
_get_ident = threading.get_ident
_buffers: dict = {}  # thread ident -> _Buffer
_gc_span = None


class _Buffer:
    """One thread's spans since the last ``take``.  A span's handle is
    ``base`` + its row here: handles count every span the thread opened,
    so one taken already (handle < base) is left alone by ``close``."""

    __slots__ = ("thread", "base", "name", "start", "end", "parent",
                 "a", "b", "stack")

    def __init__(self, thread: int):
        self.thread = thread
        self.base = 0
        self.stack: list = []           # handles of open spans
        self.clear()

    def clear(self) -> None:
        self.name: list = []            # None once discarded
        self.start = array("q")
        self.end = array("q")
        self.parent = array("q")        # handle, -1 for a root
        self.a = array("q")
        self.b = array("q")


@dataclasses.dataclass(frozen=True)
class Spans:
    """Recorded spans as columns, ordered by start.  ``start``/``end``
    are ``time.monotonic_ns()``; ``end`` is -1 for a span still open
    when taken; ``parent`` indexes these columns, -1 for a root or a
    parent taken earlier."""

    name: np.ndarray     # str
    start: np.ndarray    # int64 ns
    end: np.ndarray      # int64 ns
    thread: np.ndarray   # uint64 thread ident
    parent: np.ndarray   # int64
    a: np.ndarray        # int64
    b: np.ndarray        # int64

    def __len__(self) -> int:
        return len(self.name)


def open(name: str, a: int = 0, b: int = 0) -> int:
    """Start a span on this thread; returns the handle ``close`` takes."""
    tid = _get_ident()
    buf = _buffers.get(tid)
    if buf is None:
        buf = _buffers.setdefault(tid, _Buffer(tid))
    h = buf.base + len(buf.name)
    stack = buf.stack
    buf.parent.append(stack[-1] if stack else -1)
    buf.name.append(name)
    buf.start.append(_monotonic_ns())
    buf.end.append(-1)
    buf.a.append(a)
    buf.b.append(b)
    stack.append(h)
    return h


def close(h: int, a: int | None = None, b: int | None = None) -> None:
    """End the span `h`, setting any attribute given."""
    t = _monotonic_ns()
    buf = _buffers.get(_get_ident())
    if buf is None:
        return
    stack = buf.stack
    if stack and stack[-1] == h:
        stack.pop()
    elif h in stack:
        del stack[stack.index(h):]   # and any child an exception left open
    i = h - buf.base
    if i < 0:
        return
    buf.end[i] = t
    if a is not None:
        buf.a[i] = a
    if b is not None:
        buf.b[i] = b


def enclosing_a() -> int:
    """The ``a`` of the innermost span open on this thread (0 for none):
    how a site that does not know its micro-batch names it from the
    pipeline span around it."""
    buf = _buffers.get(_get_ident())
    if buf is None or not buf.stack:
        return 0
    i = buf.stack[-1] - buf.base
    return buf.a[i] if i >= 0 else 0    # taken while open: unknown


def discard(h: int) -> None:
    """Close `h` and leave it out of what ``take`` returns."""
    close(h)
    buf = _buffers.get(_get_ident())
    if buf is not None and h >= buf.base:
        buf.name[h - buf.base] = None


def _on_gc(phase: str, info: dict) -> None:
    global _gc_span
    if phase == "start":
        _gc_span = open("gc", info["generation"])
    elif _gc_span is not None:
        close(_gc_span)
        _gc_span = None


def start() -> None:
    """Turn recording on (and the ``gc`` spans with it)."""
    global on
    if not on:
        gc.callbacks.append(_on_gc)
        on = True


def stop() -> None:
    """Turn recording off; recorded spans stay until ``take``."""
    global on
    if on:
        on = False
        gc.callbacks.remove(_on_gc)


def _columns(buf: _Buffer, offset: int) -> dict:
    """`buf`'s spans but the discarded ones, parents as rows of the
    merged columns (which start at `offset`)."""
    n = len(buf.name)
    keep = np.fromiter((x is not None for x in buf.name), bool, n)
    row = np.cumsum(keep) - 1 + offset
    parent = np.frombuffer(buf.parent, dtype=np.int64) - buf.base
    known = (parent >= 0) & (parent < n)
    known[known] &= keep[parent[known]]
    cols = {"name": np.asarray(buf.name, dtype=object)[keep],
            "parent": np.where(known, row[np.clip(parent, 0, None)],
                               -1)[keep]}
    for k in ("start", "end", "a", "b"):
        cols[k] = np.frombuffer(getattr(buf, k), dtype=np.int64)[keep]
    cols["thread"] = np.full(len(cols["name"]), buf.thread, np.uint64)
    return cols


def take() -> Spans:
    """The spans recorded since the last ``take``, as columns; the
    recorder forgets them.  Take them after ``stop``: a span still open
    is returned with end -1 (its ``close`` then changes nothing that was
    returned), and one opened on another thread during the take may be
    lost."""
    parts, offset = [], 0
    for buf in list(_buffers.values()):
        if buf.name:
            parts.append(_columns(buf, offset))
            offset += len(parts[-1]["name"])
            buf.base += len(buf.name)
            buf.clear()
    fields = [f.name for f in dataclasses.fields(Spans)]
    if not offset:
        return Spans(**{k: np.zeros(0, dtype=object if k == "name" else
                                    np.uint64 if k == "thread" else
                                    np.int64) for k in fields})
    cols = {k: np.concatenate([p[k] for p in parts]) for k in fields}
    order = np.argsort(cols["start"], kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    parent = cols["parent"]
    cols["parent"] = np.where(parent >= 0, rank[np.maximum(parent, 0)], -1)
    return Spans(**{k: v[order] for k, v in cols.items()})
