"""The trace's reduction on a hand-made event list: device time tied to a
span by launch correlation (not by kernel name), the busy union over the
window, copies, and the idle gaps by what the host was in."""
import pytest
import torch

from portbench.trace import Trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, start, dur, device=CPU, corr=0, linked=0):
        self._v = (name, start, dur, device, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def _events():
    return [
        Event("portbench.window", 0, 1000, corr=1),
        Event("portbench.vag", 100, 200, corr=2),
        Event("cudaLaunchKernel", 150, 10, corr=40),  # a ctypes launch inside vag
        Event("any_kernel_name", 200, 300, CUDA, corr=40),
        Event("portbench.window", 0, 1000, CUDA),  # the device's copy of a span
        Event("portbench.optim", 400, 100, corr=3),
        Event("aten::mul_", 410, 20, corr=4),
        Event("cudaLaunchKernel", 415, 5, corr=41, linked=4),
        Event("elementwise", 600, 100, CUDA, corr=41, linked=4),
        Event("cudaMemcpyAsync", 800, 5, corr=42),
        Event("Memcpy DtoH (Device -> Pageable)", 850, 50, CUDA, corr=42),
    ]


def test_span_device_time_follows_launch_correlation():
    t = Trace(_events())
    assert t.window_s() == pytest.approx(1e-6)
    assert t.span_device_s("vag") == pytest.approx(300e-9)
    assert t.span_device_s("optim") == pytest.approx(100e-9)
    assert t.span_device_s("apply") is None


def test_busy_copies_and_breakdown():
    t = Trace(_events())
    assert t.busy_s() == pytest.approx(450e-9)  # 300 + 100 + 50, the span copy left out
    assert t.copy_s("DtoH") == pytest.approx(50e-9) and t.copy_s("HtoD") is None
    assert t.top_ops(2) == [["any_kernel_name", 300e-9], ["elementwise", 100e-9]]
    gaps = dict(t.idle_gaps())
    # idle: 0-200 (vag at 100), 500-600 (host), 700-850 (host), 900-1000 (host)
    assert gaps["vag"] == pytest.approx(200e-9)
    assert gaps["host"] == pytest.approx(350e-9)
