"""Engine and pipeline: median host wall of the step() calls that served
something, in the window before the first traced slice."""

from hepbench.readings import percentile


def read(run):
    s = run.untraced_steps()
    return percentile((s[:, 1] - s[:, 0]) * 1e3, 50)
