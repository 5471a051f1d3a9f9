"""The port's ERD-only statistics (david.py) against the JAX package's
``erd_stats.run`` on the same case, row by row, and the ``david`` CLI on
the CPU.

The AutoERD masks are equal (the split is exact on both sides). The C and
CNR values are float32 ratios of window means and standard deviations;
the mean images are summed in another order (numpy's pairwise sum against
torch's) and torch's ``log`` and XLA's part in the last bit, so the ADC
rows' CNR, a difference of near-equal means over a spread, moves most:
read 2.4e-6 absolute at most, 3.1e-5 relative on a CNR of 0.014. Bars:
rtol 1e-5 and atol 1e-5.
"""
import csv
import os

import numpy as np
import pytest
import scipy.io as sio
import torch

from mri_super_resolution_tpu.data import Case as JCase
from mri_super_resolution_tpu.pipelines import erd_stats as jerd
from mri_super_resolution_tpu_torch.cli import david as david_cli
from mri_super_resolution_tpu_torch.data import Case
from mri_super_resolution_tpu_torch.pipelines import erd_stats

torch.set_num_threads(2)


def _cases(rng, acquisitions=(3, 3, 3)):
    """A 32 x 32 x 2 case with a bright lesion and outlier acquisitions
    (so AutoERD rejects some), as both packages' Case."""
    H = W = 32
    S, A = 2, sum(acquisitions)
    yy, xx = np.mgrid[0:H, 0:W]
    lesion = 0.6 * np.exp(-((xx - 16) ** 2 + (yy - 16) ** 2) / 12.0)
    b0 = (rng.uniform(0.8, 1.2, size=(H, W, S)) + lesion[..., None]).astype(np.float32)
    dwi = np.stack([0.6 * b0 + 0.02 * rng.normal(size=(H, W, S)) for _ in range(A)], -1)
    dwi[..., ::4] *= rng.uniform(0.3, 0.6, size=(H, W, S, 1))  # drop-outs
    dwi = dwi.astype(np.float32)

    def make(cls):
        return cls(pt_id="18-1681-88", b=900.0, cancer_loc=(16, 16), contralateral_loc=(10, 22),
                   noise=(26, 6), cancer_slice=1, acquisitions=acquisitions, dwi=dwi.copy(),
                   b0=b0, erd=np.ones_like(b0), accept=np.ones(dwi.shape, np.int32))

    return make(JCase), make(Case)


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("acquisitions", [(3, 3, 3), (2, 3, 4)])
def test_erd_stats_matches_jax(tmp_path, acquisitions):
    jcase, tcase = _cases(np.random.default_rng(sum(acquisitions)), acquisitions)
    want = _rows(jerd.run([jcase], str(tmp_path / "jax"), "d"))
    got = _rows(erd_stats.run([tcase], str(tmp_path / "torch"), "d", device="cpu"))
    assert got[0] == want[0] == list(erd_stats.HEADER)
    assert len(got) == len(want) == 1 + 2 * sum(2 * a + 4 for a in acquisitions)
    np.testing.assert_array_equal(tcase.accept, jcase.accept)
    assert 0 < (tcase.accept[:, :, 1] == 0).mean() < 0.5  # AutoERD rejected some
    for g, w in zip(got[1:], want[1:]):
        assert g[:5] == w[:5]
        np.testing.assert_allclose(float(g[5]), float(w[5]), rtol=1e-5, atol=1e-5,
                                   err_msg=str(g))


def test_david_cli_on_cpu(tmp_path, monkeypatch):
    """cli/david.py on one registry patient (18-1681-07: cancer slice 11,
    acquisitions (9, 9, 9) synthesised from the mean b0)."""
    rng = np.random.default_rng(4)
    data = tmp_path / "data"
    data.mkdir()
    yy, xx = np.mgrid[0:100, 0:100] / 99.0
    blob = 40 + 200 * np.exp(-((xx - 0.6) ** 2 + (yy - 0.7) ** 2) / 0.05)
    vol = (blob[..., None] * np.ones(12) + rng.uniform(0, 5, (100, 100, 12))).astype(np.float32)
    sio.savemat(data / "pat07_mean_b0.mat", {"data_mean_b0": vol})
    sio.savemat(data / "pat07_ERD.mat", {"ADC_alldata_mm_ERD": np.ones_like(vol)})
    monkeypatch.setenv("MRI_SR_DATA_DIR", str(data))
    path = david_cli.main(["--limit_cases", "1", "--out_folder", str(tmp_path / "out"),
                           "--experiment_name", "smoke", "--device", "cpu"])
    assert path == os.path.join(str(tmp_path / "out"), "smoke.csv")
    rows = _rows(path)
    assert rows[0] == list(erd_stats.HEADER) and len(rows) == 1 + 3 * (9 * 4 + 8)
    assert {r[1] for r in rows[1:]} == {"DWI", "ADC", "DWI_ERD", "ADC_ERD"}
    assert all(np.isfinite(float(r[5])) for r in rows[1:])
