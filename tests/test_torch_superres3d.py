"""The port's 3-D pipeline as a whole against the JAX package's.

The tiny setup of ``tests/test_superres3d.py`` (24x24x3 synthetic patient,
8 combinations, 30 epochs of which 4 alternate, hidden 32) runs through both
``run_patient``s. The port gets the JAX-drawn Fourier matrix and initial
params (split as the JAX pipeline splits its key) through ``init=``; the JAX
pipeline runs on the CPU, where it takes its autodiff path.

Measured gaps on this setup (port on the CPU, plain versions of K1-K3):
recon_2x / sr_hr_grid 2.4e-7, SSIM 1.0e-6, ADC 7.2e-7. Tolerances: 1e-5 on
the volumes and SSIM, 1e-4 on the ADC maps (a log of the signal).

The WIRE path (``inr_model="wire"``, 4 -> 32x2 -> 1 on the raw coordinates,
PerturbNet on 4 inputs, wire_lr 1e-3) on the same patient: the port runs the
plain K4 for the mean steps (single exponential, hand backward) where the JAX
pipeline takes autodiff of the two-exponential model on the CPU, so the fits
differ by rounding only. Measured gaps (30 epochs, 4 alternating): fitted
weights 7.6e-7, PerturbNet 5.8e-11, recon_2x / sr_hr_grid / coronal 2.0e-5
(omega = sigma = 10 make the output sensitive to its weights: d out / d W
reaches 2 sigma^2 |s| ~ 1e2), SSIM 1.9e-6, ADC 3.2e-4; the trainable route
(12 epochs, autograd on both sides) recon 1.4e-5, ADC 1.1e-3. Tolerances
(WIRE_TOL): about 10x the largest measured gap on the weights, volumes and
SSIM; 3e-3 on the ADC maps (values 0 to 10), about 3x the trainable run's
1.1e-3 and 10x the other's 3.2e-4.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.config import SupperresDWIConfig as JConfig
from mri_super_resolution_tpu.core.coords import fourier_encode, fourier_matrix, mgrid
from mri_super_resolution_tpu.data import MetricsCSV, SSIM_HEADER, save_mat, synthetic
from mri_super_resolution_tpu.models import PerturbNet as JPerturbNet
from mri_super_resolution_tpu.models import Siren as JSiren
from mri_super_resolution_tpu.models import Wire as JWire
from mri_super_resolution_tpu.pipelines import superres3d as jsr
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.cli import superres_dwi as tcli
from mri_super_resolution_tpu_torch.config import SupperresDWIConfig as TConfig
from mri_super_resolution_tpu_torch.pipelines import superres3d as tsr

torch.set_num_threads(2)

KW = dict(number_of_epochs=30, perturbation_epochs=4, hidden_dim=32, num_layers=1,
          pn_dim=16, roi_start=4, roi_end=20, mapping_size=16)
BVALUES = np.asarray([0.0, 150.0, 1000.0, 1500.0])


def _jax_init(cfg, lr_shape, seed=0):
    """B and initial params exactly as the JAX run_patient draws them."""
    kB, kI, kP = jax.random.split(jax.random.key(seed), 3)
    B = fourier_matrix(kB, cfg.mapping_size, len(lr_shape), scale=cfg.ff_scale)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    if cfg.inr_model == "wire":
        ff = mgrid(lr_shape)
        inr = JWire(hidden_features=cfg.wire_hidden, hidden_layers=cfg.wire_layers,
                    omega_0=cfg.wire_omega, sigma_0=cfg.wire_sigma,
                    trainable=cfg.wire_trainable).init(kI, ff[:8])
        inr_sd = convert.wire_state_dict(to_np(inr))
    else:
        ff = fourier_encode(mgrid(lr_shape), B)
        inr = JSiren(hidden_features=cfg.hidden_dim, hidden_layers=cfg.num_layers).init(
            kI, ff[:8])
        inr_sd = convert.siren_state_dict(to_np(inr))
    pn = JPerturbNet(hidden_features=cfg.pn_dim, dimension=len(lr_shape)).init(
        kP, ff[:8], 0, 0.0)
    return {"B": np.array(B), "inr": inr_sd,
            "pn": convert.perturbnet_state_dict(to_np(pn))}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    rng = np.random.default_rng(0)
    b0 = np.abs(rng.normal(1.0, 0.3, size=(24, 24, 3))).astype(np.float32)
    hybrid = synthetic.hybrid_from_b0(b0, acq_counts=(1, 2, 2, 2), seed=1)
    jcfg, tcfg = JConfig(**KW), TConfig(**KW)
    d = tmp_path_factory.mktemp("jax_csv")
    jcsv = MetricsCSV(str(d / "ssim_scores.csv"), SSIM_HEADER)
    jres = jsr.run_patient(hybrid, BVALUES, jcfg, seed=0, csv=jcsv, pt_id=99)
    init = _jax_init(tcfg, (8, 8, 3, 4))
    np.testing.assert_array_equal(init["B"], jres.B)
    tres = tsr.run_patient(hybrid, BVALUES, tcfg, seed=0, pt_id=99, device="cpu",
                           init=init)
    return dict(hybrid=hybrid, jcfg=jcfg, tcfg=tcfg, jres=jres, tres=tres, init=init,
                jcsv=jcsv.path)


def test_volumes_match(both):
    jres, tres = both["jres"], both["tres"]
    np.testing.assert_array_equal(tres.mean_img, jres.mean_img)
    np.testing.assert_array_equal(tres.maxes, jres.maxes)
    assert tres.recon_2x.shape == jres.recon_2x.shape == (32, 32, 3, 4)
    assert tres.sr_hr_grid.shape == jres.sr_hr_grid.shape == (16, 16, 3, 4)
    np.testing.assert_allclose(tres.recon_2x, jres.recon_2x, atol=1e-5)
    np.testing.assert_allclose(tres.sr_hr_grid, jres.sr_hr_grid, atol=1e-5)
    assert (tres.recon_2x >= 0).all()
    # the fitted INR itself
    jw = convert.siren_weights(jax.tree.map(np.asarray, jres.inr_params))
    for a, b in zip(tres.inr.weights(), jw):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_ssim_rows_match(both):
    jrows, trows = both["jres"].ssim_rows, both["tres"].ssim_rows
    assert len(trows) == len(jrows) == 3 * 4
    for t, j in zip(trows, jrows):
        assert t[:3] == j[:3]
        np.testing.assert_allclose(t[3:], j[3:], atol=1e-5)


@pytest.mark.parametrize("_slice", [0, 1, 2])
def test_adc_maps_match(both, _slice):
    jm = jsr.adc_maps(both["jres"], both["jcfg"], _slice)
    tm = tsr.adc_maps(both["tres"], both["tcfg"], _slice)
    for t, j in zip(tm, jm):
        assert t.shape == j.shape == (32, 32)
        np.testing.assert_allclose(t, j, atol=1e-4)


def test_coronal_recon_matches(both):
    inr = JSiren(hidden_features=32, hidden_layers=1)
    j = jsr.coronal_recon(both["jres"], inr.apply, both["jcfg"], transverse_length=6)
    t = tsr.coronal_recon(both["tres"], both["tcfg"], transverse_length=6)
    assert t.shape == j.shape == (32, 32, 6, 1)
    np.testing.assert_allclose(t, j, atol=1e-5)


def test_run_writes_csv_and_timings(both, tmp_path):
    out = tsr.run([(99, both["hybrid"], BVALUES)], both["tcfg"], str(tmp_path), seed=0,
                  device="cpu", init=both["init"], export_npz=True)
    lines = open(os.path.join(out, "pat99", "ssim_scores.csv")).read().splitlines()
    jlines = open(both["jcsv"]).read().splitlines()
    assert lines[0] == jlines[0] and len(lines) == len(jlines) == 1 + 12
    for a, b in zip(lines[1:], jlines[1:]):
        ta, tb = a.split(","), b.split(",")
        assert ta[:3] == tb[:3]
        np.testing.assert_allclose(np.float64(ta[3:]), np.float64(tb[3:]), atol=1e-5)
    import json

    timings = json.load(open(os.path.join(out, "timings.json")))
    assert timings["platform"] == "cpu" and timings["patients"][0]["pt_id"] == "99"
    assert os.path.isfile(os.path.join(out, "zero_shot_dwi.npz"))


def test_cuda_requested_without_a_card_raises(both):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tsr.run_patient(both["hybrid"], BVALUES, both["tcfg"])
    with pytest.raises(RuntimeError, match="cuda"):
        tsr.run([(1, both["hybrid"], BVALUES)], both["tcfg"], "unused")


def test_unported_options_raise(both, tmp_path):
    with pytest.raises(ValueError, match="unknown inr_model"):
        tsr.run_patient(both["hybrid"], BVALUES,
                        dataclasses.replace(both["tcfg"], inr_model="mlp"),
                        device="cpu")
    with pytest.raises(NotImplementedError):
        tsr.run([(1, both["hybrid"], BVALUES)], both["tcfg"], str(tmp_path),
                device="cpu", export_artifact=True)


def test_odd_roi_and_plain_route(both):
    """Odd ROI side (spline crop). The plain route (use_pallas=False) is the
    CPU's route anyway, and is refused for the card before any device is
    touched: the card always runs the kernels."""
    rng = np.random.default_rng(1)
    b0 = np.abs(rng.normal(1.0, 0.3, size=(24, 24, 2))).astype(np.float32)
    hybrid = synthetic.hybrid_from_b0(b0, acq_counts=(1, 2, 2, 2), seed=1)
    cfg = TConfig(number_of_epochs=10, perturbation_epochs=2, hidden_dim=16,
                  num_layers=1, pn_dim=8, roi_start=4, roi_end=19, mapping_size=8)
    a = tsr.run_patient(hybrid, BVALUES, cfg, seed=0, device="cpu")
    assert a.recon_2x.shape == (30, 30, 2, 4)
    assert np.isfinite(a.recon_2x).all() and (a.recon_2x >= 0).all()
    for m in tsr.adc_maps(a, cfg, 0):
        assert m.shape == (30, 30) and np.isfinite(m).all()
    plain = dataclasses.replace(cfg, use_pallas=False)
    with pytest.raises(ValueError, match="use_pallas"):
        tsr.run_patient(hybrid, BVALUES, plain, device="cuda")
    with pytest.raises(ValueError, match="use_pallas"):
        tsr.run([(1, hybrid, BVALUES)], plain, "unused", device="cuda")


def test_cli_runs_on_cpu(both, tmp_path):
    mat = np.empty((4, 4), dtype=object)
    for b in range(4):
        for te in range(4):
            mat[b, te] = both["hybrid"][b][te]
    path = str(tmp_path / "p1" / "master.mat")
    save_mat(path, {"hybrid_raw": mat, "b": BVALUES[None, :]})
    out = str(tmp_path / "out")
    tcli.main(["--master_mats", path, "--epochs", "4", "--pn_epochs", "2",
               "--hidden_dim", "16", "--num_layers", "1", "--mapping_size", "8",
               "--roi_start", "4", "--roi_end", "20", "--device", "cpu", "--out", out])
    lines = open(os.path.join(out, "patp1", "ssim_scores.csv")).read().splitlines()
    assert len(lines) == 1 + 3 * 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tcli.main(["--master_mats", path, "--epochs", "2", "--pn_epochs", "0",
                       "--out", out])


# ---------------------------------------------------------------------------
# the WIRE path
# ---------------------------------------------------------------------------

WIRE_KW = dict(KW, inr_model="wire", wire_hidden=32, wire_layers=2)
WIRE_TOL = dict(weights=1e-5, volume=2e-4, ssim=2e-5, adc=3e-3)


@pytest.fixture(scope="module")
def wire_both(both):
    jcfg, tcfg = JConfig(**WIRE_KW), TConfig(**WIRE_KW)
    jres = jsr.run_patient(both["hybrid"], BVALUES, jcfg, seed=0, pt_id=99)
    init = _jax_init(tcfg, (8, 8, 3, 4))
    np.testing.assert_array_equal(init["B"], jres.B)
    tres = tsr.run_patient(both["hybrid"], BVALUES, tcfg, seed=0, pt_id=99, device="cpu",
                           init=init)
    return dict(jcfg=jcfg, tcfg=tcfg, jres=jres, tres=tres)


def test_wire_volumes_match(wire_both):
    jres, tres = wire_both["jres"], wire_both["tres"]
    assert tres.recon_2x.shape == jres.recon_2x.shape == (32, 32, 3, 4)
    assert tres.sr_hr_grid.shape == jres.sr_hr_grid.shape == (16, 16, 3, 4)
    np.testing.assert_allclose(tres.recon_2x, jres.recon_2x, atol=WIRE_TOL["volume"])
    np.testing.assert_allclose(tres.sr_hr_grid, jres.sr_hr_grid, atol=WIRE_TOL["volume"])
    assert (tres.recon_2x >= 0).all() and tres.timings["inr_model"] == "wire"
    # the fitted INR, omega/sigma untouched (trainable=False)
    jw, joms = convert.wire_weights(jax.tree.map(np.asarray, jres.inr_params))
    for a, b in zip(tres.inr.weights(), jw):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=WIRE_TOL["weights"])
    got = torch.stack([s.detach() for s in tres.inr.scales()]).view(-1, 2)
    torch.testing.assert_close(got, joms, rtol=0, atol=0)
    # the PerturbNet moved, through the INR's input, as the JAX one did
    jpn = list(convert.perturbnet_state_dict(
        jax.tree.map(np.asarray, jres.pn_params)).values())
    for a, b in zip(tres.pn.weights(), jpn):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_wire_ssim_rows_match(wire_both):
    jrows, trows = wire_both["jres"].ssim_rows, wire_both["tres"].ssim_rows
    assert len(trows) == len(jrows) == 3 * 4
    for t, j in zip(trows, jrows):
        assert t[:3] == j[:3]
        np.testing.assert_allclose(t[3:], j[3:], atol=WIRE_TOL["ssim"])


@pytest.mark.parametrize("_slice", [0, 2])
def test_wire_adc_maps_match(wire_both, _slice):
    jm = jsr.adc_maps(wire_both["jres"], wire_both["jcfg"], _slice)
    tm = tsr.adc_maps(wire_both["tres"], wire_both["tcfg"], _slice)
    for t, j in zip(tm, jm):
        assert t.shape == j.shape == (32, 32)
        np.testing.assert_allclose(t, j, atol=WIRE_TOL["adc"])


def test_wire_coronal_recon_matches(wire_both):
    """Raw coordinates (no B) on the coronal grid, through K5's plain
    version on the CPU."""
    cfg = wire_both["jcfg"]
    inr = JWire(hidden_features=cfg.wire_hidden, hidden_layers=cfg.wire_layers)
    j = jsr.coronal_recon(wire_both["jres"], inr.apply, cfg, transverse_length=6)
    t = tsr.coronal_recon(wire_both["tres"], wire_both["tcfg"], transverse_length=6)
    assert t.shape == j.shape == (32, 32, 6, 1)
    np.testing.assert_allclose(t, j, atol=WIRE_TOL["volume"])


def test_wire_trainable_route(both):
    """wire_trainable: the mean steps take autograd over the plain module
    (omega/sigma move), inference still runs K5's route; on the CPU the
    result matches the JAX pipeline's trainable run."""
    kw = dict(WIRE_KW, number_of_epochs=12, perturbation_epochs=2, wire_trainable=True)
    jres = jsr.run_patient(both["hybrid"], BVALUES, JConfig(**kw), seed=0)
    tcfg = TConfig(**kw)
    tres = tsr.run_patient(both["hybrid"], BVALUES, tcfg, seed=0, device="cpu",
                           init=_jax_init(tcfg, (8, 8, 3, 4)))
    _, joms = convert.wire_weights(jax.tree.map(np.asarray, jres.inr_params))
    got = torch.stack([s.detach() for s in tres.inr.scales()]).view(-1, 2)
    assert not torch.equal(got, torch.full_like(got, 10.0))
    torch.testing.assert_close(got, joms, rtol=1e-5, atol=0)
    np.testing.assert_allclose(tres.recon_2x, jres.recon_2x, atol=WIRE_TOL["volume"])
    for _slice in range(3):
        jm = jsr.adc_maps(jres, JConfig(**kw), _slice)
        for t, j in zip(tsr.adc_maps(tres, tcfg, _slice), jm):
            np.testing.assert_allclose(t, j, atol=WIRE_TOL["adc"])


def test_wire_cli_runs_on_cpu(both, tmp_path):
    mat = np.empty((4, 4), dtype=object)
    for b in range(4):
        for te in range(4):
            mat[b, te] = both["hybrid"][b][te]
    path = str(tmp_path / "p1" / "master.mat")
    save_mat(path, {"hybrid_raw": mat, "b": BVALUES[None, :]})
    out = str(tmp_path / "out")
    tcli.main(["--master_mats", path, "--epochs", "4", "--pn_epochs", "2",
               "--inr_model", "wire", "--wire_hidden", "16", "--wire_layers", "1",
               "--roi_start", "4", "--roi_end", "20", "--device", "cpu", "--out", out])
    lines = open(os.path.join(out, "patp1", "ssim_scores.csv")).read().splitlines()
    assert len(lines) == 1 + 3 * 4
    import json

    timings = json.load(open(os.path.join(out, "timings.json")))
    assert timings["config"]["inr_model"] == "wire"
