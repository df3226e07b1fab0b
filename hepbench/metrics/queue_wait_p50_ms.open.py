"""Batcher: median of due time -> start of the step() that answered it,
over answered requests due in the window before its first traced
slice."""

from hepbench.readings import answered_in_window, percentile, step_of


def read(run):
    m = answered_in_window(run) & run.untraced
    if not m.any() or not len(run.steps):
        return None
    start = run.steps[step_of(run, run.done[m]), 0]
    return percentile((start - run.due[m]) * 1e3, 50)
