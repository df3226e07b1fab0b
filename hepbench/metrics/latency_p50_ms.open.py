"""The whole request path, in an open cell: median, over every answered
request due in the window, of due time -> answer on the host."""

from hepbench.readings import latency_ms, percentile


def read(run):
    return percentile(latency_ms(run), 50)
