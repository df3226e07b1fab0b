"""95th percentile, over every answered request due in the window, of due
time -> answer on the host."""

from hepbench.readings import latency_ms, percentile


def read(run):
    return percentile(latency_ms(run), 95)
