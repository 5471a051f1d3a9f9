"""The harness finds every configuration, traffic mix, cell, entry and
metric by its name, and a new one is found by adding files alone."""
import json
import shutil
from pathlib import Path

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = harness.Cell(name)
    assert cell.cfg and cell.traffic and cell.limits
    assert hasattr(cell.entry, "Driver") and callable(cell.entry.expected)
    assert callable(cell.entry.compare)
    assert cell.ref.__file__.endswith(f"configs/{cell.spec['config']}.py")
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_module_found_by_name(metric):
    module = harness.load_module(harness.BENCH / "metrics" / f"{metric}.py")
    assert callable(module.read)


def test_metrics_listed_only_where_they_apply():
    fit = harness.Cell("sr3d_ref.fit")
    names = {m["name"] for m in fit.per_layer}
    assert "k1_roofline.sr3d" in names and "k3_roofline.infer" not in names
    assert {m["name"] for m in fit.end_to_end} == {"fit_voxels_per_s", "setup_s"}


def test_the_2d_ensemble_is_added_by_entries_alone():
    from portbench.tests.tiny import bench

    cell = harness.Cell("ens2d_ref.fit", bench=bench())
    assert {m["name"] for m in cell.end_to_end} == {"ensemble_voxels_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "optim_host_ms.ens2d", "kernel_host_ms.ens2d", "k1w_roofline.ens2d", "mfu.ens2d",
        "device_idle_share.ens2d"}


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.Cell("no_such.cell")


def test_a_cell_added_by_files_alone(tmp_path, monkeypatch):
    """A copy of the benchmark's folder with one more cell and one more
    metric, added as files and entries, runs without an edit elsewhere."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "sr3d_ref.fit2", "config": "sr3d_siren_reference",
                               "traffic": "mean_phase_short", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "steps.fit2", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "fit loop and optimizer",
                               "moves": "fit_voxels_per_s", "workloads": ["sr3d_ref.fit2"]})
    for m in bench["end_to_end"]:
        if m["name"] == "fit_voxels_per_s":
            m["workloads"].append("sr3d_ref.fit2")
    traffic = json.loads((root / "portbench/traffic/mean_phase.json").read_text())
    traffic["unit"]["num_epochs"] = 100
    (root / "portbench/traffic/mean_phase_short.json").write_text(json.dumps(traffic))
    shutil.copy(root / "portbench/workloads/sr3d_ref.fit.json",
                root / "portbench/workloads/sr3d_ref.fit2.json")
    (root / "portbench/metrics/steps.fit2.py").write_text(
        "def read(run):\n    return run['window']['attempted']\n")
    monkeypatch.setattr(harness, "BENCH", root / "portbench")
    cell = harness.Cell("sr3d_ref.fit2", bench=bench)
    assert cell.traffic["unit"]["num_epochs"] == 100
    assert [m["name"] for m in cell.per_layer][-1] == "steps.fit2"
    run = {"window": {"attempted": 7}}
    assert harness.load_module(root / "portbench/metrics/steps.fit2.py").read(run) == 7
