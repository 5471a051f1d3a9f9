"""The port's data layer against the JAX package's: synthetic patients,
combination expansion and mean, CSV and DICOM bytes."""
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.data import combinations as jcomb
from mri_super_resolution_tpu.data import io as jio
from mri_super_resolution_tpu.data import synthetic as jsyn
from mri_super_resolution_tpu_torch.data import combinations as tcomb
from mri_super_resolution_tpu_torch.data import io as tio
from mri_super_resolution_tpu_torch.data import synthetic as tsyn

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def b0():
    rng = np.random.default_rng(0)
    return np.abs(rng.normal(1.0, 0.3, size=(12, 10, 3))).astype(np.float32)


@pytest.mark.parametrize("kwargs", [
    dict(acq_counts=(1, 2, 3, 2), seed=1),
    dict(acq_counts=(1, 2, 2, 2), seed=3, dedup_te=True, shift_sigma=0.0),
])
def test_hybrid_from_b0_identical(b0, kwargs):
    a = jsyn.hybrid_from_b0(b0, **kwargs)
    b = tsyn.hybrid_from_b0(b0, **kwargs)
    for b_i in range(4):
        for te in range(4):
            np.testing.assert_array_equal(a[b_i][te], b[b_i][te])


def test_hybrid_from_tissue_identical(b0):
    a, ga = jsyn.hybrid_from_tissue(b0, acq_counts=(1, 2, 2, 2), seed=2)
    b, gb = tsyn.hybrid_from_tissue(b0, acq_counts=(1, 2, 2, 2), seed=2)
    for b_i in range(4):
        for te in range(4):
            np.testing.assert_array_equal(a[b_i][te], b[b_i][te])
    for k in ga:
        np.testing.assert_array_equal(ga[k], gb[k])


def test_expand_combinations_exact(b0):
    hybrid = jsyn.hybrid_from_b0(b0, acq_counts=(1, 3, 2, 4), seed=4)
    ref = np.asarray(jcomb.expand_from_hybrid(hybrid, te=0))
    got = tcomb.expand_combinations(*[torch.as_tensor(hybrid[b][0]) for b in range(4)])
    assert got.shape == ref.shape == (12, 10, 3, 4, 3 * 2 * 4)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("te", [0, 1])
def test_combination_mean_exact(b0, te):
    hybrid = jsyn.hybrid_from_b0(b0, acq_counts=(1, 3, 5, 5), seed=5)
    ref = jcomb.combination_mean(hybrid, te=te)
    got = tcomb.combination_mean(hybrid, te=te)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_metrics_csv_same_bytes(tmp_path):
    rows = [(7, 0.0, 0, 0.123456789, -0.5), ("pt", 1500.0, 27, 1e-9, 1.0)]
    paths = []
    for mod, name in ((jio, "a.csv"), (tio, "b.csv")):
        csv = mod.MetricsCSV(str(tmp_path / name), mod.SSIM_HEADER)
        for r in rows:
            csv.append(*r)
        paths.append(tmp_path / name)
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_save_dicom_same_bytes(tmp_path):
    img = np.random.default_rng(1).normal(0, 300, size=(9, 7))
    path = tmp_path / "d" / "x.dcm"  # the UIDs hash the path: write both there
    jio.save_dicom(img, str(path))
    ja = path.read_bytes()
    tio.save_dicom(img, str(path))
    assert path.read_bytes() == ja
    np.testing.assert_array_equal(jio.read_dicom_pixels(str(path)), img.astype(np.int16))


@pytest.mark.parametrize("v73", [False, True])
def test_load_mat_same(tmp_path, v73):
    data = {"hybrid_raw": np.empty((2, 2), dtype=object), "b": np.arange(4.0)}
    for i in range(2):
        for j in range(2):
            data["hybrid_raw"][i, j] = np.full((3, 2, 2), i * 2 + j, np.float32)
    path = str(tmp_path / "m.mat")
    (jio.save_mat73 if v73 else jio.save_mat)(path, data)
    a = jio.load_mat(path)
    b = tio.load_mat(path)
    assert sorted(a) == sorted(b)
    np.testing.assert_array_equal(np.asarray(a["b"]), np.asarray(b["b"]))
    for i in range(2):
        for j in range(2):
            np.testing.assert_array_equal(a["hybrid_raw"][i][j], b["hybrid_raw"][i][j])
    with pytest.raises(KeyError):
        tio.load_mat(path, "missing")
