"""Engine and pipeline: host wall of the step() calls that served
something, summed, over their answers (the window before its first
traced slice)."""


def read(run):
    s = run.untraced_steps()
    if not len(s):
        return None
    return float((s[:, 1] - s[:, 0]).sum() / s[:, 2].sum() * 1e6)
