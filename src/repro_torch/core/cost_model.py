"""Framework-free pricing algebra the mapper and the serving runtime
call: per-segment times from a kernel/boundary split, and the two-stage
pipeline makespan.

The port has no analytic hardware model yet (ROADMAP queue 1 item 4):
every price it uses comes from a measured ``ProfileTable``.
"""

from __future__ import annotations


def segment_times_from_split(
    segments, kernels, boundaries
) -> tuple:
    """Seconds per segment for a configuration's kernel/boundary split.

    ``segments`` is any sequence of objects with ``start``/``stop``/
    ``on_device`` (``repro_torch.core.mapper.Segment`` duck-typed);
    ``kernels``/``boundaries`` are the per-layer attributions.  A device
    segment charges boundary only on its edge layers (interior
    roundtrips are elided by the segment executor), host segments
    charge every layer's stored boundary (zero for CPU placements by
    construction).
    """
    out = []
    for seg in segments:
        t = 0.0
        for i in range(seg.start, seg.stop):
            t += kernels[i]
            if seg.on_device:
                if i in (seg.start, seg.stop - 1):
                    t += boundaries[i]
            else:
                t += boundaries[i]
        out.append(t)
    return tuple(out)


def pipeline_makespan(
    host_s: float, device_s: float, n_microbatches: int
) -> float:
    """Makespan of a two-stage software pipeline over a micro-batch
    stream (``repro_torch.serving.pipeline``): host stage ``host_s``,
    device stage ``device_s`` per micro-batch, overlapped across
    micro-batches::

        makespan = host_s + device_s + (n - 1) * max(host_s, device_s)
    """
    if n_microbatches <= 0:
        return 0.0
    return (
        host_s
        + device_s
        + (n_microbatches - 1) * max(host_s, device_s)
    )
