"""Device: 1 - (union of kernel and copy intervals) / wall, over the
first complete traced slice."""

from hepbench.readings import complete_slice


def read(run):
    sl = complete_slice(run)
    if sl is None:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
