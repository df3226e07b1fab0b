"""Batcher: answers per step() that served something, over the window's
steps before the first traced slice."""


def read(run):
    s = run.untraced_steps()
    return float(s[:, 2].sum() / len(s)) if len(s) else None
