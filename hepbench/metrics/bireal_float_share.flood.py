"""Float layers: the share of the device's busy time (union of kernel and
copy intervals) outside the family's kernels (``xnor_gemm_kernel``),
over the first complete traced slice: whether the float side (real
layers, the units' sign, gather and epilogue, the copies) or the binary
GEMM sets the device's pace.  Launches on one stream do not overlap, so
busy less the kernels' own time is the rest's."""

from hepbench.readings import complete_slice


def read(run):
    sl = complete_slice(run)
    if sl is None or sl.busy_s <= 0:
        return None
    return 100.0 * (sl.busy_s - sum(sl.kernel_s.values())) / sl.busy_s
