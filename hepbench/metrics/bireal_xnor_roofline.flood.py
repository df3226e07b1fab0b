"""Kernels: Σ launch bound / Σ device time of ``xnor_gemm_kernel`` over
the first complete traced slice whose launches are those the mapping
predicts: one per device-placed Bi-Real unit per micro-batch answered in
the slice, equal to the counters' and the trace's.  Each bound is
``roofline_bireal.unit_launch_bound_s`` at the micro-batch's padded
rows."""

from hepbench import roofline_bireal as rb
from hepbench.readings import microbatches, pad_to

WRAPPER = "xnor_gemm_cuda"


def device_units(run) -> list:
    from repro_torch.core.parallel_config import is_host_config

    return [i for i in rb.units(run.layers)
            if not is_host_config(run.served.layer_configs[i])]


def slice_bound_s(run, sl):
    """Σ unit launch bounds over the slice, or None unless the predicted
    launches equal the counters' and the trace's."""
    placed = device_units(run)
    n, bound = 0, 0.0
    for rows in microbatches(run, sl):
        padded = pad_to(rows, run.allowed)
        for i in placed:
            n += 1
            bound += rb.unit_launch_bound_s(run.layers[i], padded)
    if not n or {WRAPPER: n} != sl.launched or {WRAPPER: n} != sl.traced:
        return None
    return bound


def read(run):
    for sl in run.slices:
        device = sl.kernel_s.get(WRAPPER, 0.0)
        bound = slice_bound_s(run, sl) if sl.complete else None
        if bound is not None and device > 0:
            return 100.0 * bound / device
    return None
