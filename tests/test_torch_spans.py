"""The program's spans (``utils/profiling.py``): off, they record nothing,
open no profiler range and leave every result bit for bit as it was; under
``torch.profiler`` they record the fit loop's steps, the optimizer, the
kernel entries and the dense-grid request in the order and nesting the
code runs them, on the profiler's own clock, and close when their body
raises."""
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mri_super_resolution_tpu_torch.core.coords import fourier_encode, fourier_matrix, mgrid
from mri_super_resolution_tpu_torch.fit import engine
from mri_super_resolution_tpu_torch.fit.optim import Adam
from mri_super_resolution_tpu_torch.models import PerturbNet, Siren, perturbnet_apply
from mri_super_resolution_tpu_torch.ops.siren_kernel import siren_fused, siren_loss_grads
from mri_super_resolution_tpu_torch.utils import profiling
from mri_super_resolution_tpu_torch.utils.profiling import Span, clear, recorded, span

torch.set_num_threads(2)

SHAPE = (5, 4, 3, 4)  # the LR grid: 240 rows
N_ACQ = 3
GRID, CHUNK = (7, 6, 3, 4), 100  # 504 rows in 6 chunks


def _problem():
    g = torch.Generator().manual_seed(0)
    B = fourier_matrix(g, 8, 4, 0.5)
    ff = fourier_encode(mgrid(SHAPE), B)
    P = ff.shape[0]
    inr = Siren(16, 32, 1, generator=g).requires_grad_(False)
    pn = PerturbNet(16, 8, 4, generator=g).requires_grad_(False)
    return dict(B=B, ff=ff, target=torch.rand(P, 1, generator=g),
                acq=torch.rand(N_ACQ, P, 1, generator=g), inr=inr.weights(), pn=pn.weights())


def _apply(params, x):
    return siren_fused(x, params)


def _vag(params, x, target):
    return siren_loss_grads(x, params, target)


def _fit(p):
    """Epochs 0-1 on the mean, then epoch 2 (one PerturbNet step an
    acquisition) and epoch 3 (one more mean step)."""
    res = engine.fit_alternating_pn(
        _apply, perturbnet_apply, Adam([w.clone() for w in p["inr"]], 1e-4),
        Adam([w.clone() for w in p["pn"]], 1e-3), p["ff"], p["target"], p["acq"], p["B"],
        num_epochs=4, pn_epochs=2, inr_value_and_grad=_vag)
    return [res.losses, *res.inr_params, *res.pn_params]


def _infer(p):
    return engine.infer_dense_grid(_apply, p["inr"], GRID, chunk=CHUNK, clamp_min=0.0,
                                   fourier_B=p["B"])


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _children(spans, parent):
    """The spans directly inside ``parent`` on its thread, by start."""
    return sorted((s for s in spans if s.parent == parent.name and s.thread == parent.thread
                   and parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns),
                  key=lambda s: s.start_ns)


@pytest.fixture(autouse=True)
def _empty():
    clear()
    yield
    clear()


def test_off_records_nothing_opens_no_range_and_changes_no_result(monkeypatch):
    p = _problem()
    traced_fit, _ = _profiled(lambda: _fit(p))
    traced_infer, _ = _profiled(lambda: _infer(p))
    assert recorded()
    clear()

    def no_range(name):
        raise AssertionError(f"span {name!r} opened a profiler range with no profiler on")

    monkeypatch.setattr(profiling, "_Range", no_range)
    plain_fit, plain_infer = _fit(p), _infer(p)
    assert recorded() == []
    for a, b in zip(plain_fit, traced_fit):
        assert torch.equal(a, b)
    assert np.array_equal(plain_infer, traced_infer)


def test_fit_alternating_pn_records_its_steps_kernels_and_optimizer():
    p = _problem()
    _profiled(lambda: _fit(p))
    spans = recorded()
    roots = sorted((s for s in spans if s.parent is None), key=lambda s: s.start_ns)
    assert [s.name for s in roots] == ["fit.inr_step"] * 2 + ["fit.pn_step"] * N_ACQ + [
        "fit.inr_step"]
    for s in roots:
        want = (["kernel.siren_loss_grads", "optim.step"] if s.name == "fit.inr_step" else
                ["kernel.siren_forward", "kernel.siren_fused_bwd", "optim.step"])
        assert [c.name for c in _children(spans, s)] == want
    assert not [s for s in spans if s.name == "kernel.launch"]  # the CPU runs no kernel
    counts = {n: sum(s.name == n for s in spans) for n in {s.name for s in spans}}
    assert counts == {"fit.inr_step": 3, "fit.pn_step": N_ACQ, "optim.step": 3 + N_ACQ,
                      "kernel.siren_loss_grads": 3, "kernel.siren_forward": N_ACQ,
                      "kernel.siren_fused_bwd": N_ACQ}


def test_infer_dense_grid_records_the_request_and_each_chunk():
    p = _problem()
    _profiled(lambda: _infer(p))
    spans = recorded()
    (request,) = [s for s in spans if s.parent is None]
    assert request.name == "infer.request"
    n_chunks = -(-int(np.prod(GRID)) // CHUNK)
    assert [c.name for c in _children(spans, request)] == (
        ["infer.grid"] + ["infer.chunk"] * n_chunks + ["infer.gather", "infer.to_host"])
    for chunk in _children(spans, request)[1:1 + n_chunks]:
        assert [c.name for c in _children(spans, chunk)] == [
            "infer.coords", "infer.encode", "kernel.siren_forward"]
    assert len(spans) == 4 + 4 * n_chunks


def test_spans_lie_on_the_profilers_clock():
    p = _problem()
    _, prof = _profiled(lambda: (_fit(p), _infer(p)))
    spans = recorded()
    events: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in {s.name for s in spans}:
        mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs), name
        for (s, t), (ps, pt) in zip(mine, theirs):
            assert abs(s - ps) < 1_000_000 and abs(t - pt) < 1_000_000, name
            assert s <= t


def test_a_span_whose_body_raises_closes():
    @span("deco")
    def fails():
        raise ValueError("inside")

    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with span("outer"):
                with span("inner"):
                    raise ValueError("inside")
        with pytest.raises(ValueError):
            fails()
        with span("after"):
            pass
    assert [(s.name, s.parent) for s in recorded()] == [
        ("inner", "outer"), ("outer", None), ("deco", None), ("after", None)]
    assert profiling._open.names == []
    assert all(isinstance(s, Span) and s.start_ns <= s.end_ns for s in recorded())


def test_a_span_on_another_thread_has_no_parent_here(monkeypatch):
    """The profiler's state reaches autograd's device threads, not a plain
    thread: on both, a span's parent is on its own thread."""
    monkeypatch.setattr(profiling, "_collecting", lambda: True)
    worker = threading.Thread(target=lambda: span("other")(lambda: None)())
    with span("main"):
        worker.start()
        worker.join(timeout=30)
    assert not worker.is_alive()
    other, main = recorded()
    assert (other.name, other.parent, main.name) == ("other", None, "main")
    assert other.thread != main.thread == threading.get_ident()


def test_trace_shows_the_spans_as_named_ranges(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        with span("infer.request"):
            torch.ones(8).sum()
    with open(tmp_path / "t" / "trace.json") as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert "infer.request" in names
    assert [s.name for s in recorded()] == ["infer.request"]
    clear()
    assert recorded() == []


def test_decorated_entries_keep_their_names():
    from mri_super_resolution_tpu_torch.ops import siren_kernel

    for name in ("siren_forward", "siren_loss_grads", "siren_loss_grads_batched",
                 "siren_fused_bwd"):
        fn = getattr(siren_kernel, name)
        assert fn.__name__ == name and fn.__doc__ and fn.__wrapped__.__name__ == name
    assert Adam.step.__wrapped__ is not None
