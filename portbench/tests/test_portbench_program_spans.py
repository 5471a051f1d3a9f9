"""The program's spans read against a hand-made trace (``metrics/_program.py``
and the metrics that read it): device time launched inside a span's
intervals, from any thread; the device's idle time inside them, clipped
to the window; that idle time by innermost span; and nothing read from a
program that records no spans."""
import pytest
import torch

from mri_super_resolution_tpu_torch.utils import profiling
from mri_super_resolution_tpu_torch.utils.profiling import Span
from portbench import harness
from portbench.metrics import _count, _program
from portbench.trace import Trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MAIN, AUTOGRAD = 1, 2  # thread ids
DIMS = [16, 32, 32, 1]


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


def _trace():
    return Trace([
        Event("portbench.window", 0, 1000, corr=1),
        Event("cudaLaunchKernel", 150, 5, corr=40),  # eager work of the step
        Event("eager", 200, 60, CUDA, corr=40),
        Event("cudaLaunchKernel", 320, 5, corr=41),  # K2, from autograd's thread
        Event("k2", 330, 170, CUDA, corr=41),
        Event("aten::mul_", 510, 20, corr=4),  # Adam: linked to its host op
        Event("cudaLaunchKernel", 515, 5, corr=42, linked=4),
        Event("adam", 520, 40, CUDA, corr=42, linked=4),
        Event("cudaLaunchKernel", 590, 5, corr=43),  # the step's tail
        Event("tail", 600, 50, CUDA, corr=43),
        Event("cudaLaunchKernel", 690, 5, corr=44),  # outside every span
        Event("next", 700, 200, CUDA, corr=44),
    ])
    # device busy: 200-260, 330-500, 520-560, 600-650, 700-900 of 0-1000


SPANS = [
    Span("kernel.siren_forward", MAIN, "fit.pn_step", 120, 140),
    Span("kernel.siren_fused_bwd", AUTOGRAD, None, 300, 400),
    Span("optim.step", MAIN, "fit.pn_step", 500, 580),
    Span("fit.pn_step", MAIN, None, 100, 600),
    Span("kernel.launch", MAIN, "kernel.siren_loss_grads", 640, 660),
    Span("kernel.siren_loss_grads", MAIN, "fit.inr_step", 620, 700),
    Span("kernel.launch", AUTOGRAD, None, 720, 730),
    Span("kernel.siren_loss_grads", MAIN, "fit.inr_step", 710, 750),
    Span("fit.inr_step", MAIN, None, 610, 760),
    Span("optim.step", MAIN, None, 950, 1100),  # crosses the window's end
    Span("optim.step", MAIN, None, -100, -10),  # before the window: not read
]


@pytest.fixture
def run(monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: list(SPANS))
    products = [("loss_grads", DIMS, 70, 1, 5), ("input_grad", DIMS, 70, 1, 2),
                ("input_grad", [4, 8], 70, 1, 2)]
    return {"trace": _trace(), "window": {"products": products}}


def test_device_time_follows_launches_from_any_thread(run):
    recorded = _program.spans(run)
    assert len(recorded) == len(SPANS) - 1  # the span before the window left out
    tr = run["trace"]
    step = _program.intervals(recorded, "fit.pn_step")
    assert _program.device_s(tr, step) == pytest.approx(320e-9)  # 60 + 170 + 40 + 50
    bwd = _program.intervals(recorded, "kernel.siren_fused_bwd")
    assert _program.device_s(tr, bwd) == pytest.approx(170e-9)
    eager = _program.subtract(step, _program.intervals(recorded, "kernel.", "optim.step"))
    assert eager == [(100, 120), (140, 300), (400, 500), (580, 600)]
    assert _program.device_s(tr, eager) == pytest.approx(110e-9)  # 60 + 50
    assert _program.device_s(tr, _program.intervals(recorded, "nothing")) == 0.0


def test_idle_time_inside_spans_is_clipped_to_the_window(run):
    recorded = _program.spans(run)
    tr = run["trace"]
    assert _program.idle(tr) == [(0, 200), (260, 330), (500, 520), (560, 600), (650, 700),
                                 (900, 1000)]
    optim = _program.intervals(recorded, "optim.step")
    # 500-520 and 560-580 in the first step; 950-1000 of the second, not 950-1100
    assert _program.idle_s(tr, optim) == pytest.approx(90e-9)
    assert _program.idle_s(Trace([Event("portbench.window", 0, 10, corr=1)]), optim) is None


def test_idle_split_by_innermost_span(run):
    main = [s for s in _program.spans(run) if s.thread == MAIN]
    split = _program.idle_split(run["trace"], main)
    # fit.pn_step 100-600 self: 100-120, 140-200, 260-330, 580-600 (idle parts)
    assert split["fit.pn_step"] == pytest.approx((20 + 60 + 70 + 20) * 1e-9)
    assert split["optim.step"] == pytest.approx((20 + 20 + 50) * 1e-9)
    # 650-700: 650-660 inside the launch, 660-700 in the K1 call after it
    assert split["kernel.launch"] == pytest.approx(10e-9)
    assert split["kernel.siren_loss_grads"] == pytest.approx(40e-9)
    assert "fit.inr_step" not in split
    assert split[""] == pytest.approx((100 + 50) * 1e-9)  # 0-100 and 900-950: in no span
    assert sum(split.values()) == pytest.approx(sum(b - a for a, b in _program.idle(
        run["trace"])) * 1e-9)
    assert _program.innermost([s for s in main if s.end_ns <= 600]) == [
        (100, 120, "fit.pn_step"), (120, 140, "kernel.siren_forward"),
        (140, 500, "fit.pn_step"), (500, 580, "optim.step"), (580, 600, "fit.pn_step")]


def _read(name, run):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read(run)


def test_the_metrics_read_the_spans(run):
    rows = 70
    k2_bytes = 4 * (2 * rows * DIMS[0] + rows + _count.n_params(DIMS))
    least = 2 * max(_count.flops("input_grad", DIMS, rows) / _count.PEAK_FLOPS,
                    k2_bytes / _count.PEAK_BYTES)
    assert _read("k2_roofline.pn", run) == pytest.approx(100 * least / 170e-9)
    assert _read("pn_eager_ms.pn", run) == pytest.approx(110e-9 * 1e3)
    assert _read("optim_idle_ms.fit", run) == pytest.approx(90e-9 * 1e3 / 2)
    # the second K1 call's launch is on another thread: only the first is read
    assert _read("kernel_prep_ms.fit", run) == pytest.approx(60e-9 * 1e3)
    assert _read("request_idle_ms.infer", run) is None


@pytest.mark.parametrize("name", ["k2_roofline.pn", "pn_eager_ms.pn", "optim_idle_ms.fit",
                                  "kernel_prep_ms.fit", "request_idle_ms.infer"])
def test_a_program_without_spans_gives_nothing(run, monkeypatch, name):
    monkeypatch.delattr(profiling, "recorded")
    assert _program.spans(run) is None
    assert _read(name, run) is None
    assert _read(name, {"trace": None, "window": run["window"]}) is None
