"""The control on the card: the plain reference put in the program's place
and computed in TF32, the nearest precision below the configurations'
float32, fails a cell's check. At a reduced patient and grid size so that
a test run holds it (the cell's own sizes are read by ``calibrate.py``)."""
import pytest
import torch

from portbench import harness
from portbench.tests.tiny import bench

SMALL = {
    "sr3d_ref.fit": {"config": {"patient_shape": [64, 64, 8], "roi_start": 8, "roi_end": 56}},
    "sr3d_ref.infer": {"traffic": {"grids": [[50, 50, 8, 4], [25, 25, 8, 4], [50, 50, 50, 1]]}},
    "ens2d_ref.fit": {},
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SMALL))
def test_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = harness.Cell(name, bench=bench(), overrides=SMALL[name])
    for seed in (11, 12, 13):
        driver = cell.driver(seed, "cuda:0")
        driver.setup()
        inputs = driver.inputs()
        driver.free()
        reference = cell.expected(inputs, "float32")
        control = cell.readings(cell.expected(inputs, "tf32"), inputs, reference)
        ok, compared = harness.checks(cell, control)
        assert not ok, compared
