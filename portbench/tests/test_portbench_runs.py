"""Whole runs of each cell at tiny sizes on the CPU (the program's plain
routes): a sound run is correct, each fault the cell can have, planted in
the timed path, makes it not correct, and the result line is well formed.
The look for a card and the window's length are the only parts of a chip
run these skip."""
import json
import math
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import OVERRIDES, bench

FAULTS = {"sr3d_ref.fit": ["unchanged", "half_batch"], "sr3d_ref.pn": ["unchanged", "half_batch"],
          "ens2d_ref.fit": ["unchanged", "half_batch"], "sr3d_ref.infer": ["altered", "half_batch"]}
SEED = 2 ** 33 + 5  # more than 32 signed bits hold


def _run(name, fault=None, trace=False):
    torch.set_num_threads(2)
    cell = harness.Cell(name, bench=bench(), overrides=OVERRIDES[name])
    run = harness.measure(cell, SEED, 0.2, trace, "cpu", time.perf_counter(), fault=fault)
    return cell, run, harness.result_line(cell, run, trace, "cpu")


@pytest.mark.parametrize("name", list(FAULTS))
def test_sound_run_is_correct_and_its_line_well_formed(name):
    cell, run, line = _run(name)
    assert line["correct"] is True, line["checks"]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in line["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0 and m["unit"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert json.loads(json.dumps(line)) == line


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in FAULTS.items() for f in fs])
def test_planted_fault_is_not_correct(name, fault):
    _, _, line = _run(name, fault)
    assert line["correct"] is False, line["checks"]


def test_traced_run_reports_per_layer_metrics_it_can_read():
    # on the CPU the trace holds no device activity: only the spans' metrics
    # are read, and no device metric is written
    cell, run, line = _run("ens2d_ref.fit", trace=True)
    assert run["spans"].calls["vag"] > 0 and run["spans"].calls["optim"] > 0
    assert set(line["metrics"]) == {"optim_host_ms.ens2d", "kernel_host_ms.ens2d"}
    assert line["device"]["busy_s"] is None and line["device"]["window_s"] > 0
    assert line["breakdown"] == {"device_ops": [], "idle_gaps": []}


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload",
                           "sr3d_ref.fit", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


NO_JAX = """
import sys, time
sys.path.insert(0, {root!r})
import torch
from portbench import harness
from portbench.tests.tiny import OVERRIDES, bench
cell = harness.Cell({name!r}, bench=bench(), overrides=OVERRIDES[{name!r}])
run = harness.measure(cell, 3, 0.1, False, "cpu", time.perf_counter())
harness.result_line(cell, run, False, "cpu")
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & {{"mri_super_resolution_tpu_torch", "portbench"}}), harness.forbidden_modules())
"""


@pytest.mark.parametrize("name", list(FAULTS))
def test_a_cells_run_path_loads_no_jax(name):
    """The cell's whole run path in a fresh process; the loaded modules'
    top-level names compared whole against JAX's and the JAX package's."""
    code = NO_JAX.format(root=str(harness.ROOT), name=name)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert last == "['mri_super_resolution_tpu_torch', 'portbench'] []", last


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mri_super_resolution_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mri_super_resolution_tpu.core", sys)
    assert harness.forbidden_modules() == ["mri_super_resolution_tpu"]
