"""Client: 95th percentile of how late each submit entered the queue
against its due time, over the requests due in the window before its
first traced slice."""

from hepbench.readings import percentile


def read(run):
    m = run.untraced
    return percentile((run.submit[m] - run.due[m]) * 1e3, 95)
