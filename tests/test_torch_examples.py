"""The port's examples (``mri_super_resolution_tpu_torch/examples/``) against
the JAX package's ``examples/``: the phantoms and their acquisitions equal
the originals' (all numpy; the original is loaded by path), and each
example's ``main()`` runs on the CPU at tiny settings and prints its rows.
``phantom_sanity``'s gates pass on a small configuration (32 x 32 phantoms,
a 32 x 2 SIREN to loss 5e-4), and fail on rows that break them."""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from mri_super_resolution_tpu_torch.examples import phantom_sanity, sr3d_demo, wire_vs_siren
from mri_super_resolution_tpu_torch.pipelines.lowres_qual import LowresQualConfig

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(hidden_features=32, hidden_layers=2, loss_threshold=5e-4, phase2_steps=5,
             max_pretrain_steps=2000)


@pytest.fixture(scope="module")
def original():
    """The JAX package's ``examples/phantom_sanity.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_phantom_sanity", os.path.join(REPO, "examples", "phantom_sanity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("side", [64, 32])
def test_phantoms_and_acquisitions_equal_the_originals(original, side):
    for name in ("water_phantom", "kiwi_phantom"):
        img = getattr(phantom_sanity, name)(side)
        np.testing.assert_array_equal(img, getattr(original, name)(side))
        np.testing.assert_array_equal(phantom_sanity.acquisitions(img),
                                      original.acquisitions(img))


def test_phantom_sanity_passes_its_gates(tmp_path, capsys):
    rows = phantom_sanity.main(["--device", "cpu", "--out_dir", str(tmp_path)],
                               cfg=LowresQualConfig(**SMALL), side=32)
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(ln) for ln in lines[:2]] == rows
    assert [r["phantom"] for r in rows] == ["water", "kiwi"]
    assert lines[-1] == "phantom sanity OK"


def test_phantom_gates_refuse_bad_rows():
    water = {"cv_sr": 0.1, "cv_acq_mean": 0.1}
    kiwi = {"ssim_sr_vs_clean": 0.6, "ssim_spline_vs_clean": 0.62}
    phantom_sanity.check_gates(water, kiwi)
    with pytest.raises(AssertionError, match="water"):
        phantom_sanity.check_gates({**water, "cv_sr": 0.2}, kiwi)
    with pytest.raises(AssertionError, match="kiwi"):
        phantom_sanity.check_gates(water, {**kiwi, "ssim_sr_vs_clean": 0.5})


def test_sr3d_demo_prints_its_table(capsys):
    rng = np.random.default_rng(0)
    b0 = np.abs(rng.normal(1.0, 0.3, (24, 24, 2))).astype(np.float32)
    res = sr3d_demo.main(["--epochs", "4", "--pn_epochs", "2", "--device", "cpu"], b0=b0,
                         hidden_dim=16, num_layers=1, mapping_size=8, pn_dim=8, roi_start=4,
                         roi_end=20)
    out = capsys.readouterr().out
    assert "slice  b-value  SSIM(spline)  SSIM(SR)" in out
    assert len(res.ssim_rows) == 2 * 4 and res.losses.shape == (4,)
    assert f"on {sum(r[4] > r[3] for r in res.ssim_rows)}/8 slice x b combinations" in out


def test_wire_vs_siren_prints_both_fits(capsys):
    img = np.random.default_rng(1).uniform(0.1, 1.0, (16, 16)).astype(np.float32)
    res = wire_vs_siren.main(["--steps", "5", "--hidden", "16", "--device", "cpu"], img=img)
    out = capsys.readouterr().out
    assert out.startswith("bicubic(2x) baseline: PSNR")
    for name in ("SIREN", "WIRE"):
        assert f"{name}: final loss" in out
        assert np.isfinite(res[name]).all()


def test_examples_default_to_the_card():
    """Like every entry point of the port, the examples run on the card
    unless asked for the CPU: without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        wire_vs_siren.main(["--steps", "1"], img=np.ones((4, 4), np.float32))
