"""Device traces of slices of a run's window, held against the port's
launch counters.

A slice is taken in three moves, each at a step boundary of the dispatch
loop, where the card is idle (a ``step()`` returns once its answers are
on the host): ``start`` begins a profiler that records device activity
only (kernels, copies, sets), ``mark`` opens the slice at least
MARK_AFTER_S later, once the backlog that the profiler's start built up
(it holds the interpreter lock for a while) has drained, and ``stop``
closes it.  The method is
``chip_smoke.py``'s ``traced`` / ``device_trace``: the profiler drops
launch records now and then (often the first ones of a trace), so
``start`` waits SETTLE_S and launches PRIMERS spin kernels, which are
left out of every sum, and a slice whose trace holds fewer launches of a
kernel than the wrapper counted between ``mark`` and ``stop`` is lossy:
its busy and idle numbers are wrong, and the readers take the first
slice that is complete.

The last primer ends just before ``start`` reads the host's clock, so
that instant ties the trace's clock to the host's, to within the few
microseconds a synchronize takes to return: the slice keeps the device
work that began after ``mark``, and each idle gap of the card is named by
what the dispatch loop was doing in it (``step``, ``poll`` or
``drain``).
"""

from __future__ import annotations

import bisect
import dataclasses
import time

SETTLE_S = 0.02
MARK_AFTER_S = 0.3
PRIMERS = 8
PRIMER = "spin_kernel"


@dataclasses.dataclass
class Slice:
    begin: float              # host clock (time.monotonic) at start()
    t0: float                 # ... at mark(): the slice proper
    t1: float                 # ... at stop()
    launched: dict            # wrapper -> launches the counters saw
    traced: dict              # wrapper -> launches in the trace
    kernel_s: dict            # wrapper -> device seconds of its kernel
    busy_s: float             # union of kernel and copy intervals
    device_ops: list          # [(name, seconds)], most first
    idle_gaps: list           # [(loop span, seconds)], longest first

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def complete(self) -> bool:
        return all(self.traced.get(k, 0) >= n
                   for k, n in self.launched.items())


class Tracer:
    """Takes profiled slices; `counts()` -> {wrapper: launches so far};
    `kernels`: wrapper -> its CUDA kernel as the profiler names it (the
    family's ``KERNELS``)."""

    def __init__(self, counts, kernels: dict):
        self._counts = counts
        self._kernels = kernels
        self._prof = None
        self._t0 = None
        self._pending: list = []

    @property
    def active(self) -> bool:
        return self._prof is not None

    @property
    def marked(self) -> bool:
        return self._t0 is not None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._begin = time.monotonic()
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        time.sleep(SETTLE_S)
        for _ in range(PRIMERS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self._align = time.monotonic()
        self._t0 = None

    def warm(self) -> None:
        """One start and stop before the window, so that the setting up
        of the tracing library that a process's first profiler start
        does (it holds the interpreter lock for up to seconds) falls
        outside it."""
        self.start()
        self._prof.stop()
        self._prof = None

    def mark(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._t0 = time.monotonic()
        self._before = self._counts()

    def stop(self) -> None:
        """Close the slice (a slice never marked is dropped)."""
        import torch

        torch.cuda.synchronize()
        t1 = time.monotonic()
        after = self._counts()
        self._prof.stop()
        if self._t0 is not None:
            launched = {k: after[k] - self._before.get(k, 0) for k in after
                        if after[k] > self._before.get(k, 0)}
            self._pending.append((self._prof, self._begin, self._align,
                                  self._t0, t1, launched))
        self._prof = self._t0 = None

    def finish(self, steps, t_end: float) -> list:
        """Every slice, read once the window has closed; `steps` are the
        loop's non-empty steps (host start, end, answers)."""
        return [read_slice(*p, steps, t_end, self._kernels)
                for p in self._pending]


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].removeprefix("void ").strip()[:60]


def read_slice(prof, begin: float, align: float, t0: float, t1: float,
               launched: dict, steps, t_end: float, kernels: dict) -> Slice:
    from torch.autograd import DeviceType

    events, primer_end = [], None
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        if PRIMER in ev.name:
            primer_end = e if primer_end is None else max(primer_end, e)
        else:
            events.append((s, e, _short(ev.name)))
    if primer_end is None:              # cannot tie the clocks: lossy
        return Slice(begin, t0, t1, launched, {}, {}, 0.0, [], [])
    # trace microseconds -> host seconds; the card is idle at t0, so a
    # few microseconds of slack keep every launch of the slice
    dev = [(align + (s - primer_end) / 1e6, align + (e - primer_end) / 1e6,
            name) for s, e, name in events]
    dev = [d for d in dev if d[0] >= t0 - 20e-6]
    traced, kernel_s, by_name = {}, {}, {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        for wrapper, kernel in kernels.items():
            if kernel in name:
                traced[wrapper] = traced.get(wrapper, 0) + 1
                kernel_s[wrapper] = kernel_s.get(wrapper, 0.0) + (e - s)
    merged = []
    for s, e, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    starts = [float(st[0]) for st in steps]
    gaps = []
    for a, b in zip(edges[::2], edges[1::2]):
        a, b = max(a, t0), min(b, t1)
        if b > a:
            gaps.append((_loop_span(steps, starts, a, b, t_end), b - a))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return Slice(begin, t0, t1, launched, traced, kernel_s, busy, ops[:10],
                 gaps[:10])


def _loop_span(steps, starts, a: float, b: float, t_end: float) -> str:
    """What the dispatch loop did over most of [a, b]: a serving
    ``step``, or else ``poll`` (an empty step and the wait after it) in
    the window and ``drain`` after it."""
    inside = 0.0
    i = max(0, bisect.bisect_right(starts, a) - 1)
    while i < len(steps) and steps[i][0] < b:
        inside += max(0.0, min(steps[i][1], b) - max(steps[i][0], a))
        i += 1
    if inside > (b - a) / 2:
        return "step"
    return "poll" if a < t_end else "drain"
