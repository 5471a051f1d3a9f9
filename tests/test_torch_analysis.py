"""The port's CSV analysis (analyze_results.ipynb, observe_epochs.m) and LR
panel dumper (selectLRs.py): ``summarize_contrast`` against the JAX
package's on one CSV (the frames equal), the plots, and the
``analyze_results`` and ``select_lrs`` CLIs writing their PNGs. These run
on the CPU only: pandas, matplotlib and seaborn, no tensor work."""
import os

import numpy as np
import pandas as pd
import scipy.io as sio

from mri_super_resolution_tpu.utils import analysis as janalysis
from mri_super_resolution_tpu_torch.cli import analyze_results as analyze_cli
from mri_super_resolution_tpu_torch.cli import select_lrs as select_cli
from mri_super_resolution_tpu_torch.data import CONTRAST_HEADER, MetricsCSV, synthetic
from mri_super_resolution_tpu_torch.utils import analysis


def _contrast_csv(path):
    """A master.py-schema CSV: 2 seeds x 3 directions x 4 images x 3 metrics."""
    rng = np.random.default_rng(0)
    csv = MetricsCSV(str(path), CONTRAST_HEADER)
    for seed in range(2):
        for d in "xyz":
            for image in ("mean", "superres", "spline", "erd"):
                for metric in ("C", "CNR", "CNR2"):
                    csv.append(seed, "07", d, image, metric, round(float(rng.uniform(0, 5)), 4))
    return csv.path


def test_summarize_contrast_matches_jax(tmp_path):
    path = _contrast_csv(tmp_path / "c.csv")
    df = analysis.load_contrast_csv(path)
    pd.testing.assert_frame_equal(df, janalysis.load_contrast_csv(path))
    for metric in ("C", "CNR", "CNR2"):
        got = analysis.summarize_contrast(df, metric)
        pd.testing.assert_frame_equal(got, janalysis.summarize_contrast(df, metric))
        assert set(got.index) == {"mean", "superres", "spline", "erd"}
        assert (got["count"] == 6).all()


def test_plots_write_files(tmp_path):
    df = analysis.load_contrast_csv(_contrast_csv(tmp_path / "c.csv"))
    assert os.path.isfile(analysis.barplot_metric(df, "CNR", str(tmp_path / "p" / "bar.png"),
                                                  direction="x"))
    snaps = np.random.default_rng(1).uniform(size=(16, 16, 5)).astype(np.float32)
    assert os.path.isfile(analysis.epoch_filmstrip(snaps, snaps[..., -1],
                                                   str(tmp_path / "f.png")))
    assert os.path.isfile(analysis.epoch_gif(snaps, str(tmp_path / "e.gif")))


def test_analyze_results_cli(tmp_path):
    path = _contrast_csv(tmp_path / "c.csv")
    out = analyze_cli.main([path, "--metrics", "C", "CNR", "--out_dir", str(tmp_path / "a")])
    assert sorted(os.listdir(out)) == ["C.png", "CNR.png"]


def test_select_lrs_cli(tmp_path, monkeypatch):
    """Both sources: a master.mat, and the data directory's mean b0 with the
    hybrid volume synthesised (18-1681-07 -> pat07)."""
    b0 = np.random.default_rng(2).uniform(0.5, 1.5, (40, 40, 7)).astype(np.float32)
    data = tmp_path / "data"
    data.mkdir()
    sio.savemat(data / "pat07_mean_b0.mat", {"data_mean_b0": b0})
    hybrid = synthetic.hybrid_from_b0(b0, seed=7)
    cell = np.empty((4, 4), dtype=object)
    for b in range(4):
        for te in range(4):
            cell[b, te] = hybrid[b][te]
    (tmp_path / "p1").mkdir()
    mat = str(tmp_path / "p1" / "master.mat")
    sio.savemat(mat, {"hybrid_raw": cell, "b": np.array([[0.0, 150.0, 1000.0, 1500.0]])})

    out = select_cli.main(["--master_mats", mat, "--roi_start", "4", "--roi_end", "20",
                           "--limit_slices", "2", "--out", str(tmp_path / "o1")])
    assert sorted(os.listdir(os.path.join(out, "patp1"))) == sorted(
        f"slice_{s}_b_{b}.png" for s in (4, 5) for b in range(4))

    monkeypatch.setenv("MRI_SR_DATA_DIR", str(data))
    out = select_cli.main(["--roi_start", "4", "--roi_end", "20", "--first_slice", "6",
                           "--out", str(tmp_path / "o2")])
    assert sorted(os.listdir(os.path.join(out, "pat07"))) == [
        f"slice_6_b_{b}.png" for b in range(4)]


def test_mean_images():
    b0 = np.random.default_rng(3).uniform(0.5, 1.5, (10, 10, 3)).astype(np.float32)
    hybrid = synthetic.hybrid_from_b0(b0, seed=1)
    m = select_cli.mean_images(hybrid, (0.0, 150.0, 1000.0, 1500.0))
    assert m.shape == (10, 10, 3, 4) and float(m.max()) <= 1.0
    vol = np.asarray(hybrid[2][0], np.float32)
    np.testing.assert_allclose(m[..., 2], (vol / vol.max()).mean(-1), rtol=1e-6)
