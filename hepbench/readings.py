"""What the metric readers share: latencies, the window's steps, and the
launches of a traced slice.

Percentiles are numpy's (linear between order statistics) over every
request of the population, never over medians of chunks.
"""

from __future__ import annotations

import numpy as np

from hepbench import roofline


def percentile(values, q: float):
    values = np.asarray(values, float)
    return float(np.percentile(values, q)) if values.size else None


def answered_in_window(run) -> np.ndarray:
    """Requests due in the window that were answered."""
    return run.in_window & ~np.isnan(run.done)


def latency_ms(run) -> np.ndarray:
    """Due time -> answer on the host, of every answered request due in
    the window."""
    m = answered_in_window(run)
    return (run.done[m] - run.due[m]) * 1e3


def correct_in_window(run) -> int:
    """Correct answers that reached the host inside the window."""
    return int(np.sum(run.ok & (run.done >= run.t0) & (run.done < run.t_end)))


def step_of(run, done: np.ndarray) -> np.ndarray:
    """Index of the non-empty step whose span holds each answer time."""
    ends = run.steps[:, 1]
    return np.minimum(np.searchsorted(ends, done, "left"), len(ends) - 1)


def complete_slice(run):
    """The first traced slice whose trace lost no launch, or None."""
    for sl in run.slices:
        if sl.complete:
            return sl
    return None


def pad_to(n: int, allowed) -> int:
    return min(s for s in allowed if s >= n)


def microbatches(run, sl) -> list:
    """Real rows of each micro-batch answered inside slice `sl`: an
    engine completes the requests of one micro-batch at one clock read."""
    done = run.done[~np.isnan(run.done)]
    done = done[(done >= sl.t0) & (done <= sl.t1)]
    _, counts = np.unique(done, return_counts=True)
    return [int(c) for c in counts]


def launches(run) -> list:
    """[(wrapper, start, stop)] the served mapping launches for one
    micro-batch: one ``segment_cuda`` per fused span, one
    ``xnor_gemm_cuda`` per other device-placed conv or fc layer."""
    from repro_torch.core.parallel_config import is_host_config

    served = run.served
    fused = [(a, b) for a, b, *_ in served.fused_segments]
    inside = {i for a, b in fused for i in range(a, b)}
    out = [("segment_cuda", a, b) for a, b in fused]
    for i, (layer, cfg) in enumerate(zip(run.layers, served.layer_configs)):
        if (i not in inside and layer.kind in ("conv", "fc")
                and not is_host_config(cfg)):
            out.append(("xnor_gemm_cuda", i, i + 1))
    return out


def slice_bound_s(run, sl):
    """Σ launch bounds over the slice's kernels, or None unless the
    launches the mapping predicts from the answered micro-batches equal
    the counters' and the trace's."""
    predicted, bound = {}, 0.0
    for n in microbatches(run, sl):
        rows = pad_to(n, run.allowed)
        for wrapper, a, b in launches(run):
            predicted[wrapper] = predicted.get(wrapper, 0) + 1
            bound += roofline.launch_bound_s(run.layers, a, b, rows)
    if not predicted or predicted != sl.launched or predicted != sl.traced:
        return None
    return bound
