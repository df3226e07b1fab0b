"""The reading of a traced slice, on a profiler's events made by hand: the
clocks tied by the last primer, device work before the slice's mark
left out, busy time as a union, idle gaps named by the loop's spans, and
the kernel-roofline reader held to the mapping's predicted launches."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from hepbench import trace
from hepbench.families.hepbnn import KERNELS


def _ev(name, start_us, end_us, device=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start_us,
                                                      end=end_us))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _slice(launched):
    # the last primer ends at trace time 1,000 us = host 10.0 s
    events = [
        _ev("spin_kernel", 900, 1000),
        _ev("segment_kernel", 1010, 1040),          # before the mark
        _ev("void segment_kernel<int>(int*)", 1200, 1300),
        _ev("Memcpy HtoD (Pinned -> Device)", 1280, 1320),
        _ev("segment_kernel", 1500, 1600),
        _ev("aten::empty", 1100, 1900, DeviceType.CPU),
    ]
    steps = [(10.00015, 10.00035, 16), (10.0004, 10.00065, 16)]
    return trace.read_slice(_Prof(events), 9.9, 10.0, 10.0001, 10.0008,
                            launched, steps, 20.0, KERNELS)


def test_slice_keeps_the_work_after_its_mark():
    sl = _slice({"segment_cuda": 2})
    assert sl.traced == {"segment_cuda": 2} and sl.complete
    assert sl.kernel_s["segment_cuda"] == pytest.approx(200e-6)
    # union of [1200, 1320] and [1500, 1600] us
    assert sl.busy_s == pytest.approx(220e-6)
    assert sl.window_s == pytest.approx(700e-6)
    assert dict(sl.device_ops)["segment_kernel"] == pytest.approx(200e-6)
    # gaps after the mark: [100, 200] us (the first step covers half),
    # [320, 500] us (the steps cover 130 of it), [600, 800] us (50)
    assert sl.idle_gaps == [
        ("poll", pytest.approx(200e-6)), ("step", pytest.approx(180e-6)),
        ("poll", pytest.approx(100e-6))]


def test_slice_that_lost_launches_is_not_complete():
    assert not _slice({"segment_cuda": 3}).complete
    assert not _slice({"segment_cuda": 2, "xnor_gemm_cuda": 1}).complete
