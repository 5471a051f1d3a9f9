"""P1's plain version (``ops/mma_probe.py``) against numpy at a small shape
(T 32, H 64, REPS 2, GRID 3), and the probe CLI on the CPU. int8: a step's
sum is exact (integers far below 2^53) and the GRID adds of float32 in
order match numpy's exactly; bf16: products of bf16 values are exact in
float32, their sums within float32 rounding (rtol 1e-5 over 128 terms)."""
import json

import numpy as np
import pytest
import torch

from mri_super_resolution_tpu_torch.cli import int8_mma_probe as probe_cli
from mri_super_resolution_tpu_torch.ops import mma_probe as mp

torch.set_num_threads(2)

T, H, REPS, GRID = 32, 64, 2, 3


def _numpy_step(a, b):
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    return sum(a64[r * T:(r + 1) * T] @ b64 for r in range(REPS))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_plain_probe_matches_numpy(dtype):
    a, b = probe_cli.operands(dtype, T, H, REPS, seed=3)
    an, bn = a.float().numpy(), b.float().numpy()
    step = mp.mma_probe_step_ref(a, b, REPS)
    want_step = _numpy_step(an, bn)
    out = mp.mma_probe(a, b, REPS, GRID)
    want = np.zeros((T, H), np.float32)
    for _ in range(GRID):
        want += want_step.astype(np.float32)
    assert step.dtype == out.dtype == torch.float32 and out.shape == (T, H)
    if dtype == torch.int8:
        np.testing.assert_array_equal(step.numpy(), want_step.astype(np.float32))
        np.testing.assert_array_equal(out.numpy(), want)
    else:
        np.testing.assert_allclose(step.numpy(), want_step, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not any(mp.LAUNCHES.values())


def test_probe_refuses_what_the_kernel_does_not_take():
    a, b = probe_cli.operands(torch.int8, T, H, REPS)
    with pytest.raises(TypeError):
        mp.mma_probe(a, b.to(torch.bfloat16), REPS, GRID)
    with pytest.raises(ValueError):
        mp.mma_probe(a, b, 3, GRID)  # 64 rows are not 3 slices
    with pytest.raises(ValueError):
        mp.mma_probe(a, b, REPS, 0)


def test_probe_cli_writes_the_jax_probe_keys(tmp_path):
    out = tmp_path / "probe.json"
    probe_cli.main(["--tile", str(T), str(H), "--reps", str(REPS), "--grid", str(GRID),
                    "--calls", "2", "--device", "cpu", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert set(rec) == {"platform", "device", "tile", "reps", "grid", "cases"}
    assert rec["platform"] == "cpu" and rec["tile"] == [T, H]
    assert (rec["reps"], rec["grid"]) == (REPS, GRID)
    assert set(rec["cases"]) == {"bf16_f32acc", "int8_i32acc"}
    for case in rec["cases"].values():
        assert set(case) == {"us_per_call", "achieved_tops"} and case["us_per_call"] > 0
