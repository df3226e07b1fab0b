"""Kernels: Σ launch bound / Σ device time over the xnor_gemm_kernel and
segment_kernel launches of the first complete traced slice whose
launches are those the mapping predicts.  Each launch's bound is that of
the layers it computes at its padded rows."""

from hepbench.readings import slice_bound_s


def read(run):
    for sl in run.slices:
        device = sum(sl.kernel_s.values())
        bound = slice_bound_s(run, sl) if sl.complete else None
        if bound is not None and device > 0:
            return 100.0 * bound / device
    return None
