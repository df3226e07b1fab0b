"""One run of one cell: set the program up, drive its window, check its
answers against the plain reference, read the metrics.

The program under test is ``repro_torch`` behind its public facade:
``api.Deployment.plan`` (profile -> map -> fuse, through a profile store
in a fixed directory of the checkout), ``serve``, then ``submit`` from
one client thread and ``step`` from one dispatch thread, the main one.
The window drives batcher -> engine -> segment pipeline -> the mapped
layers -> answers on the host.  What belongs to one network family (its
inputs, set-up, reference, agreement rule and kernel names) comes from
the configuration's family file (``spec.Bench.family``); every answer
due in the window is held to the family's reference answer of its
request by the family's rule.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import sys
import threading
import time
import traceback

import numpy as np
import torch

from hepbench import traffic
from hepbench.trace import MARK_AFTER_S, Tracer

POOL = 4096              # images a run draws its requests from
POLL_S = 1e-4            # the dispatch loop's wait after an empty step()
DRAIN_S = 60.0           # how long answers due in the window are awaited
WARM_S = 2.0             # the cell's own traffic before the window
SLICE_S = 0.5            # one traced slice of a --trace 1 window
SLICE_AT = (0.55, 0.7, 0.85)  # where in the window a slice may start


@dataclasses.dataclass
class Program:
    deployment: object
    served: object           # the served EfficientConfiguration
    payloads: np.ndarray     # one request per pool image, as submitted
    allowed: tuple           # profiled batch sizes (the batcher's pads)


@dataclasses.dataclass
class Run:
    """What a metric reader sees of one run."""

    cell: dict
    config: dict
    mix: dict
    seconds: float
    t0: float
    t_end: float
    setup_s: float
    layers: object           # the family's net (hepbnn: reference layers)
    served: object           # the served EfficientConfiguration
    allowed: tuple
    due: np.ndarray          # host clock (time.monotonic), every request
    submit: np.ndarray
    done: np.ndarray         # nan where no answer came
    image: np.ndarray
    ok: np.ndarray           # answered and agreeing with the reference
    steps: np.ndarray        # (start, end, answers) of non-empty steps
    slices: list             # trace.Slice, --trace 1 only

    @property
    def in_window(self) -> np.ndarray:
        return self.due < self.t_end

    @property
    def untraced_end(self) -> float:
        """Where the window's untraced part ends: at its first traced
        slice (they lie in its last half), so that the span metrics of a
        traced run read no profiler's cost."""
        return min([self.t_end] + [sl.begin for sl in self.slices])

    @property
    def untraced(self) -> np.ndarray:
        """Requests due in the window's untraced part."""
        return self.due < self.untraced_end

    def untraced_steps(self) -> np.ndarray:
        """Non-empty steps of the window's untraced part."""
        s = self.steps
        return s[(s[:, 0] >= self.t0) & (s[:, 1] <= self.untraced_end)]


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def seeds(seed: int, n: int) -> list:
    """`n` independent 63-bit seeds derived from the run's `seed`."""
    state = np.random.SeedSequence(int(seed)).generate_state(n, np.uint64)
    return [int(x) >> 1 for x in state]


def store_uri(root, config_name: str) -> str:
    """The profile store of a configuration: a fixed directory of the
    checkout, so that only a checkout's first run plans cold."""
    return f"dir://{root / 'build' / 'hepbench_store' / config_name}"


def served_segments(served) -> str:
    """The served segments and fused spans, e.g. ``[D1-19] fused
    1-19:seg_cuda``: what the result line carries, so that two runs on
    different mappings are told apart."""
    segs = " ".join(
        f"[{'D' if s.on_device else 'H'}{s.start + 1}-{s.stop}]"
        for s in served.segments())
    fused = " ".join(f"{a + 1}-{b}:{v}" for a, b, v, *_ in
                     served.fused_segments) or "none"
    return f"{segs} fused {fused}"


def mapping_line(served) -> str:
    layers = " ".join(f"{lab}={c}" for lab, c in
                      zip(served.layer_labels, served.layer_configs))
    return (f"mapping: proper batch {served.proper_batch_size}; segments "
            f"{served_segments(served)}; predicted "
            f"{served.expected_time_per_example * 1e6:.3f} us/img; {layers}")


class _Record:
    """The client's record of its requests.  A request leaves the
    program's hands as soon as its answer is read: the record keeps
    plain numbers and the score arrays, so the count of objects the
    collector scans stays that of the requests in flight (holding every
    ``Request`` made full collections grow through the window and stall
    it)."""

    def __init__(self):
        self.sent = 0
        self.pending = collections.deque()      # (request, due, image)
        self.due, self.image, self.submit, self.done = [], [], [], []
        self.scores = []

    def send(self, dep, payloads, due: float, image: int):
        r = dep.submit(payloads[image])
        self.pending.append((r, due, image))
        self.sent += 1
        return r

    def reap(self) -> list:
        """Record the answered requests at the head of the queue (they
        complete in order) and return their answer times."""
        out = []
        while self.pending and self.pending[0][0].done_t is not None:
            r, due, image = self.pending.popleft()
            self._keep(r, due, image, r.done_t if r.error is None else None)
            out.append(r.done_t)
        return out

    def close(self) -> None:
        """Record what is still pending as never answered."""
        while self.pending:
            r, due, image = self.pending.popleft()
            done = r.done_t if r.error is None else None
            self._keep(r, due, image, done)

    def _keep(self, r, due, image, done):
        self.due.append(due)
        self.image.append(image)
        self.submit.append(r.submit_t)
        self.done.append(np.nan if done is None else done)
        if done is not None:
            self.scores.append(np.asarray(r.result))

    def arrays(self) -> dict:
        ncls = self.scores[0].shape[0] if self.scores else 0
        return {"due": np.asarray(self.due, float),
                "submit": np.asarray(self.submit, float),
                "done": np.asarray(self.done, float),
                "image": np.asarray(self.image, np.int64),
                "scores": np.asarray(self.scores).reshape(-1, ncls)}


def _closed_client(dep, sched, payloads, t0, t_end, rec, halt):
    time.sleep(max(0.0, t0 - time.monotonic()))
    for i in range(sched.outstanding):
        rec.send(dep, payloads, t0, sched.image(i))
    i = sched.outstanding
    while rec.pending and not halt.is_set():
        try:
            rec.pending[0][0].wait(
                max(0.0, t_end + DRAIN_S - time.monotonic()))
        except TimeoutError:
            return
        except Exception:           # a failed request is answered too
            pass
        for done in rec.reap():
            if done < t_end:
                rec.send(dep, payloads, done, sched.image(i))
                i += 1


def _open_client(dep, sched, payloads, t0, t_end, rec, halt):
    for i, rel in enumerate(sched.due_s):
        if halt.is_set():
            return
        due = t0 + float(rel)
        rec.reap()
        wait = due - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        rec.send(dep, payloads, due, sched.image(i))


CLIENTS = {"closed": _closed_client, "poisson": _open_client}


def drive(program: Program, sched, seconds: float, tracer=None):
    """Run `sched` for `seconds` and wait for the answers; returns
    (t0, t_end, the requests' arrays, steps, step errors)."""
    dep, payloads = program.deployment, program.payloads
    rec, halt, steps, errors = _Record(), threading.Event(), [], []
    t0 = time.monotonic() + 0.01
    t_end = t0 + seconds
    client = threading.Thread(
        target=CLIENTS[sched.kind],
        args=(dep, sched, payloads, t0, t_end, rec, halt), daemon=True)
    slice_starts = [t0 + f * seconds for f in SLICE_AT] if tracer else []
    slice_end = mark_at = None
    answered, batch = 0, program.served.proper_batch_size
    client.start()
    try:
        while True:
            now = time.monotonic()
            if tracer is not None:
                if tracer.active and now >= min(slice_end, t_end):
                    tracer.stop()
                elif (tracer.active and not tracer.marked and now >= mark_at
                      and (rec.sent - answered <= backlog
                           or now >= mark_at + 5 * SLICE_S)):
                    tracer.mark()
                    slice_end = time.monotonic() + SLICE_S
                elif (not tracer.active and slice_starts
                      and now >= slice_starts[0]):
                    slice_starts.pop(0)
                    if now + MARK_AFTER_S + 2 * SLICE_S < t_end:
                        # the slice opens once the requests in flight are
                        # back to what they were (and a batch more), or
                        # 2.5 s on where they never are
                        backlog = rec.sent - answered + batch
                        tracer.start()
                        mark_at = time.monotonic() + MARK_AFTER_S
                        slice_end = t_end
                now = time.monotonic()
            if now >= t_end:
                if not client.is_alive() and answered >= rec.sent:
                    break
                if now >= t_end + DRAIN_S:
                    break
            try:
                n = dep.step()
            except Exception as e:          # the engine failed its requests
                errors.append(e)
                log(traceback.format_exc())
                n = 0
            if n:
                steps.append((now, time.monotonic(), n))
                answered += n
            else:
                time.sleep(POLL_S)
    finally:
        halt.set()
        if tracer is not None and tracer.active:
            tracer.stop()
        client.join(timeout=DRAIN_S)
    if client.is_alive():
        raise RuntimeError("the client thread did not stop")
    rec.reap()
    rec.close()
    return (t0, t_end, rec.arrays(), np.asarray(steps, float).reshape(-1, 3),
            errors)


def warm(program: Program, mix: dict, seed: int) -> None:
    """Every pad size once, then the cell's own traffic for WARM_S."""
    dep, payloads = program.deployment, program.payloads
    for size in program.allowed:
        reqs = [dep.submit(payloads[i]) for i in range(size)]
        dep.step(force=True)
        for r in reqs:
            try:
                r.wait(timeout=DRAIN_S)
            except Exception:       # the window's answers are what is judged
                pass
    drive(program, traffic.schedule(mix, seed, WARM_S, len(payloads)), WARM_S)


def run_cell(bench, workload: str, seed: int, seconds: float, trace: bool,
             *, device="cuda", t_start: float | None = None,
             control: bool = False) -> dict:
    """One run; returns the result line's fields and the compared
    numbers (``checks``).  ``control=True`` also reads the control: the
    family's reference in its lower precision (hepbnn: batch norms in
    bfloat16), in the program's place (the benchmark's own runs never
    do)."""
    t_start = time.monotonic() if t_start is None else t_start
    stamps = [("start", t_start)]

    def stamp(name):
        stamps.append((name, time.monotonic()))

    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    family = bench.family(config)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    s_weights, s_images, s_traffic, s_warm = seeds(seed, 4)
    stamp("imports")
    net, weights, images = family.inputs(config, s_weights, s_images, dev,
                                         POOL)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    stamp("inputs")
    program = family.build_program(config, weights, images, dev,
                                   store_uri(bench.root, cell["config"]))
    stamp("plan")
    log(mapping_line(program.served))
    warm(program, mix, s_warm)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    stamp("warm")
    setup_s = stamps[-1][1] - t_start
    log("set-up: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s"
                               for a, b in zip(stamps, stamps[1:])))

    from repro_torch.kernels import launch_counts

    tracer = (Tracer(launch_counts, family.KERNELS)
              if trace and dev.type == "cuda" else None)
    if tracer is not None:
        tracer.warm()
    sched = traffic.schedule(mix, s_traffic, seconds, POOL)
    gc.collect()
    gc.freeze()       # set-up's objects stay out of the window's collections
    try:
        t0, t_end, results, steps, errors = drive(program, sched, seconds,
                                                  tracer)
    finally:
        gc.unfreeze()
    w = steps[(steps[:, 0] >= t0) & (steps[:, 1] <= t_end)]
    if len(w):
        log(f"window: {len(w)} steps served {int(w[:, 2].sum())}, "
            f"{w[:, 2].mean():.2f} a step, steps took "
            f"{(w[:, 1] - w[:, 0]).sum() / seconds:.3f} of the window")
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    served, allowed = program.served, program.allowed
    slices = tracer.finish(steps, t_end) if tracer else []
    for sl in slices:
        log(f"slice {sl.window_s:.3f} s: busy {sl.busy_s:.6f} s, launches "
            f"counted {sl.launched}, traced {sl.traced}")
    del program
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    want = family.expected(config, net, weights, images)
    image = results["image"]
    answered = ~np.isnan(results["done"])
    seen = image[answered]
    ok = answered.copy()
    ok[answered], checks = family.agree(config, results["scores"],
                                        want[seen])
    checks["missing_answers"] = (int(np.sum(~answered)), 0)
    out = {"checks": checks}
    if control:
        low = family.expected(config, net, weights, images, control=True)
        agreed, _ = family.agree(config, low[seen], want[seen])
        out["control_wrong_answers"] = int(np.sum(~agreed))
    run = Run(cell, config, mix, seconds, t0, t_end, setup_s, net, served,
              allowed, results["due"], results["submit"], results["done"],
              image, ok, steps, slices)
    out.update(run=run, memory_peak_bytes=int(memory_peak),
               step_errors=len(errors))
    return out
