"""The RAMS serving cell, ``rams_misr.serve``, at a tiny size on the CPU (the
program's plain routes, K6's plain version included): a sound run is
correct and its line well formed, the planted faults its limits catch are
not correct (the 1% voxel reads its 1%), ``_conv.py`` counts as a hand does, the run path loads no JAX, and a traced
run's spans feed every new metric.

The tiny run serves in float32: at 3 draws of a 16 x 16 case a random
network's bfloat16 answers part from the float32 reference by far more
than the 25 averaged draws of the cell's checkpoint do (about 7e-3 of the
range), and the limits are the cell's own.
"""
import json
import math
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.metrics import _conv, _count, _program
from portbench.trace import Trace

CELL = "rams_misr.serve"
TINY = {"config": {"filters": 8, "N": 2, "r": 4, "weights": "seeded",
                   "compute_dtype": "float32"},
        "traffic": {"side": 16, "sample_size": 3}}
SEED = 2 ** 33 + 7  # more than 32 signed bits hold
NEW = ["k6_roofline.misr", "mfu.misr", "device_idle_share.misr", "request_idle_ms.misr",
       "rams_eager_ms.misr"]
CUDA = torch.autograd.DeviceType.CUDA


def _run(fault=None, trace=False):
    torch.set_num_threads(2)
    cell = harness.Cell(CELL, overrides=TINY)
    run = harness.measure(cell, SEED, 0.3, trace, "cpu", time.perf_counter(), fault=fault)
    return cell, run, harness.result_line(cell, run, trace, "cpu")


def test_sound_run_is_correct_and_its_line_well_formed():
    cell, run, line = _run()
    assert line["correct"] is True, line["checks"]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert set(line["checks"]) == set(cell.limits) == {"dwi_gap", "dwi_rms_gap", "adc_gap"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"request_p95_ms", "served_voxels_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0 and m["unit"]
    w = run["window"]
    assert w["voxels"] == w["requests"] * 48 * 48  # the mean DWI a request returns
    assert json.loads(json.dumps(line)) == line


@pytest.mark.parametrize("fault", ["half_batch", "stale"])
def test_planted_fault_is_not_correct(fault):
    _, _, line = _run(fault)
    assert line["correct"] is False, line["checks"]


def test_one_voxel_off_reads_its_share_of_the_range():
    """The 1% voxel reads 1% of the range in ``dwi_gap`` and nothing in the
    rms: below the cell's limit, which bf16's own spread (0.91% of the
    range at its worst) sets above it (PERF.md §2)."""
    cell, run, _ = _run("altered")
    assert run["readings"]["dwi_gap"] == pytest.approx(0.01, abs=1e-6)
    assert run["readings"]["dwi_rms_gap"] < 0.01 / 40
    assert cell.limits["dwi_gap"] > 0.01


def test_control_reads_above_the_sound_program():
    """The control, the reference with bfloat16 activations and tap sums, in
    the program's place, parts from the float32 reference."""
    cell, run, _ = _run()
    driver = cell.driver(SEED, "cpu")
    driver.setup()
    driver.window(0.2, harness.spans.Recorder(active=False))
    inputs = driver.inputs()
    reference = cell.expected(inputs, "float32")
    control = cell.entry.expected(cell.ref, inputs, cell.cfg, cell.traffic, "bf16_sums")
    got = cell.readings(control, inputs, reference)
    assert got["dwi_rms_gap"] > 10 * run["readings"]["dwi_rms_gap"]


@pytest.mark.parametrize("case", ["same", "valid", "pointwise", "2d"])
def test_conv_counts_match_hand_counts(case):
    if case == "same":  # a body conv at the cell's shape
        c = _conv.conv("x", 25, (130, 130, 9), (3, 3, 3), 32, 32, "SAME", 2, 2, 4)
        assert c.out == (130, 130, 9)
        assert _conv.flops(c) == 2 * 25 * 130 * 130 * 9 * 27 * 32 * 32
        assert _conv.compulsory_bytes(c) == 2 * 25 * 130 * 130 * 9 * 32 * 2 + 2 * 27 * 32 * 32 + 4 * 32
        # 2.10e11 FLOP: 0.213 ms at 989 TFLOP/s, bound by operations
        assert _conv.roofline_s(c) == pytest.approx(2.1026304e11 / 989e12, rel=1e-9)
    elif case == "valid":  # the last temporal step's conv
        c = _conv.conv("x", 25, (132, 132, 5), (3, 3, 3), 32, 32, "VALID", 2, 2, 4)
        assert c.out == (130, 130, 3)
        assert _conv.flops(c) == 2 * 25 * 130 * 130 * 3 * 27 * 32 * 32
        assert _conv.compulsory_bytes(c) == (2 * 25 * (132 * 132 * 5 * 32 + 130 * 130 * 3 * 32)
                                             + 2 * 27 * 32 * 32 + 4 * 32)
    elif case == "pointwise":  # a gate's 1x1x1 conv on the pooled features
        c = _conv.conv("x", 25, (1, 1, 1), (1, 1, 1), 32, 4, "VALID", 4, 4, 4)
        assert c.out == (1, 1, 1)
        assert _conv.flops(c) == 2 * 25 * 32 * 4
        assert _conv.compulsory_bytes(c) == 4 * (25 * 32 + 25 * 4 + 32 * 4 + 4)
        assert _conv.roofline_s(c) == _conv.compulsory_bytes(c) / _count.PEAK_BYTES
    else:  # the global path's VALID conv2d to scale^2 channels
        c = _conv.conv("x", 25, (130, 130), (3, 3), 9, 9, "VALID", 2, 2, 2)
        assert c.out == (128, 128)
        assert _conv.flops(c) == 2 * 25 * 128 * 128 * 9 * 9 * 9
        assert not _conv.body_conv(c)


def test_the_cells_forward_counts():
    cell = harness.Cell(CELL)
    convs = _conv.rams_convs(cell.cfg, 25, 128, 128)
    body = [c for c in convs if _conv.body_conv(c)]
    assert len(body) == 34  # 2 N + 1 + 3 (T // 3): K6's launches a request
    assert [c.out[2] for c in body[-9:] if c.name.startswith("reduce_convs")] == [7, 5, 3]
    total = _conv.forward_flops(convs)
    assert total == pytest.approx(6.63e12, rel=5e-3)
    assert sum(_conv.flops(c) for c in body) / total > 0.99


NO_JAX = """
import sys, time
sys.path.insert(0, {root!r})
import torch
from portbench import harness
cell = harness.Cell({cell!r}, overrides={tiny!r})
run = harness.measure(cell, 3, 0.1, False, "cpu", time.perf_counter())
harness.result_line(cell, run, False, "cpu")
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & {{"mri_super_resolution_tpu_torch", "portbench"}}), harness.forbidden_modules())
"""


def test_the_cells_run_path_loads_no_jax():
    code = NO_JAX.format(root=str(harness.ROOT), cell=CELL, tiny=TINY)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert last == "['mri_super_resolution_tpu_torch', 'portbench'] []", last


class Event:
    def __init__(self, name, start, dur, device=None, corr=0):
        self._v = (name, start, dur, device, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3] or torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return 0


def test_a_traced_run_yields_every_new_metric():
    """The spans of a traced tiny run, with device work laid into them as
    the card would launch it (the CPU traces none): 1 us of K6 a
    ``kernel.conv3d_rfab`` span, 3 us of eager work a ``rams.forward`` (at
    its start, before its first conv), and nothing else."""
    cell, run, _ = _run(trace=True)
    recorded = _program.spans(run)
    lo, hi = run["trace"].window
    events, corr = [Event("portbench.window", lo, hi - lo)], 100
    for s in recorded:
        if s.name in ("kernel.conv3d_rfab", "rams.forward"):
            corr += 1
            events.append(Event("cudaLaunchKernel", s.start_ns + 1, 1, corr=corr))
            events.append(Event(s.name + "_work", s.start_ns + 2,
                                1000 if s.name.startswith("kernel") else 3000, CUDA, corr))
    run["trace"] = Trace(events)
    got = {m: harness.load_module(harness.BENCH / "metrics" / f"{m}.py").read(run) for m in NEW}
    n_conv = sum(s.name == "kernel.conv3d_rfab" for s in recorded)
    n_req = run["window"]["requests"]
    assert n_conv == n_req * 14 and sum(s.name == "rams.forward" for s in recorded) == n_req
    least = n_req * _conv.body_least_s(run["window"]["convs"])
    assert got["k6_roofline.misr"] == pytest.approx(100 * least / (n_conv * 1e-6))
    assert got["rams_eager_ms.misr"] == pytest.approx(3e-3)
    window_s = (hi - lo) / 1e9
    flops = n_req * _conv.forward_flops(run["window"]["convs"])
    assert got["mfu.misr"] == pytest.approx(100 * flops / (window_s * _count.PEAK_FLOPS))
    assert 0 < got["device_idle_share.misr"] < 100
    assert 0 < got["request_idle_ms.misr"] < max(run["window"]["latencies_ms"])
    assert all(math.isfinite(v) for v in got.values())
