"""The port's 3-D pipeline with the grid INR (the ``quality`` and ``fast``
presets) against the JAX package's ``run_patient``.

The tiny patient of ``tests/test_torch_superres3d.py`` (24x24x3, ROI 4:20,
8 combinations) runs through both pipelines at each preset's settings
(GridINR, z_divisor 1, grid_lr 5e-3, Adam restarts), cut to a tiny width
(2 levels, base 4, F 2, hidden 8, PN 16) and schedule: ``quality`` 20
epochs of which 6 alternate, restarts every 7 INR updates, so that the
restart before the 15th update falls in the PerturbNet tail and checks
that the schedule counts across the mean fit and the tail; ``fast`` 20
epochs, no PN epochs, restarts every 7. The port gets the JAX-drawn initial
params (converted) through ``init=``. The JAX side's loss trace is read from
its ``fit_simple`` and ``fit_alternating_pn`` calls.

The JAX mean fit is its z-bucketed program (3 slices padded to 4); the
port's is unpadded. Measured gaps (both presets): loss trace 2.4e-7
relative, fitted params 9.3e-8, recon and HR grid 1.2e-7, SSIM 1.1e-6,
coronal 1.2e-7, ADC 3.6e-7. Tolerances: 1e-5 relative on the trace, 1e-5
absolute on the params, volumes and SSIM, 1e-4 on the ADC maps (a log of
the signal, values up to 10) as in ``tests/test_torch_superres3d.py``.
"""
import jax
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.fit import engine as jengine
from mri_super_resolution_tpu.config import SupperresDWIConfig as JConfig
from mri_super_resolution_tpu.core.coords import fourier_matrix, mgrid
from mri_super_resolution_tpu.data import synthetic
from mri_super_resolution_tpu.models import PerturbNet as JPerturbNet
from mri_super_resolution_tpu.pipelines import superres3d as jsr
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.config import PRESETS
from mri_super_resolution_tpu_torch.config import SupperresDWIConfig as TConfig
from mri_super_resolution_tpu_torch.pipelines import superres3d as tsr

torch.set_num_threads(2)

BVALUES = np.asarray([0.0, 150.0, 1000.0, 1500.0])
TINY = dict(hidden_dim=32, num_layers=1, pn_dim=16, roi_start=4, roi_end=20,
            mapping_size=16, grid_levels=2, grid_base_resolution=4, grid_features=2,
            grid_hidden=8)
SCHEDULES = {"quality": dict(number_of_epochs=20, perturbation_epochs=6),
             "fast": dict(number_of_epochs=20, perturbation_epochs=0)}
TRACE_RTOL, ATOL = 1e-5, 1e-5


def _preset_kw(preset: str) -> dict:
    keys = ("inr_model", "grid_z_divisor", "grid_lr", "inr_restart_every")
    kw = {k: v for k, v in PRESETS[preset].items() if k in keys}
    assert kw["inr_model"] == "grid" and kw["inr_restart_every"] == 250
    return dict(TINY, **kw, **SCHEDULES[preset]) | {"inr_restart_every": 7}


def _jax_init(cfg, lr_shape, seed=0):
    """B and initial params exactly as the JAX run_patient draws them."""
    kB, kI, kP = jax.random.split(jax.random.key(seed), 3)
    B = fourier_matrix(kB, cfg.mapping_size, len(lr_shape), scale=cfg.ff_scale)
    ff = mgrid(lr_shape)
    inr = jsr._grid_model(cfg).init(kI, ff[:8])
    pn = JPerturbNet(hidden_features=cfg.pn_dim, dimension=len(lr_shape)).init(
        kP, ff[:8], 0, 0.0)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return {"B": np.array(B), "inr": convert.grid_inr_from_flax(to_np(inr)),
            "pn": convert.perturbnet_state_dict(to_np(pn))}


@pytest.fixture(scope="module")
def hybrid():
    rng = np.random.default_rng(0)
    b0 = np.abs(rng.normal(1.0, 0.3, size=(24, 24, 3))).astype(np.float32)
    return synthetic.hybrid_from_b0(b0, acq_counts=(1, 2, 2, 2), seed=1)


@pytest.fixture(scope="module", params=["quality", "fast"])
def both(request, hybrid):
    kw = _preset_kw(request.param)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    traces = []
    mp = pytest.MonkeyPatch()
    fit_simple, fit_alt = jengine.fit_simple, jsr.fit_alternating_pn

    def simple(*a, **k):
        res = fit_simple(*a, **k)
        traces.append(np.asarray(res.losses))
        return res

    def alt(*a, **k):
        res = fit_alt(*a, **k)
        traces.append(np.asarray(res.losses))
        return res

    mp.setattr(jengine, "fit_simple", simple)
    mp.setattr(jsr, "fit_alternating_pn", alt)
    try:
        jres = jsr.run_patient(hybrid, BVALUES, jcfg, seed=0, pt_id=5)
    finally:
        mp.undo()
    init = _jax_init(tcfg, (8, 8, 3, 4))
    np.testing.assert_array_equal(init["B"], jres.B)
    tres = tsr.run_patient(hybrid, BVALUES, tcfg, seed=0, pt_id=5, device="cpu", init=init)
    return dict(preset=request.param, jcfg=jcfg, tcfg=tcfg, jres=jres, tres=tres,
                jlosses=np.concatenate(traces))


def test_loss_trace_step_by_step(both):
    j, t = both["jlosses"], both["tres"].losses
    assert t.shape == j.shape == (20,)
    np.testing.assert_allclose(t, j, rtol=TRACE_RTOL, atol=0)
    assert t[13] < t[0]


def test_fitted_params_match(both):
    jres, tres = both["jres"], both["tres"]
    want = convert.grid_inr_from_flax(jax.tree.map(np.asarray, jres.inr_params))
    for k, v in tres.inr.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=ATOL, err_msg=k)
    jpn = convert.perturbnet_state_dict(jax.tree.map(np.asarray, jres.pn_params))
    for a, b in zip(tres.pn.weights(), jpn.values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


def test_volumes_and_ssim_match(both):
    jres, tres = both["jres"], both["tres"]
    assert tres.recon_2x.shape == jres.recon_2x.shape == (32, 32, 3, 4)
    assert tres.sr_hr_grid.shape == jres.sr_hr_grid.shape == (16, 16, 3, 4)
    np.testing.assert_allclose(tres.recon_2x, jres.recon_2x, atol=ATOL)
    np.testing.assert_allclose(tres.sr_hr_grid, jres.sr_hr_grid, atol=ATOL)
    assert (tres.recon_2x >= 0).all() and tres.timings["inr_model"] == "grid"
    assert len(tres.ssim_rows) == len(jres.ssim_rows) == 12
    for t, j in zip(tres.ssim_rows, jres.ssim_rows):
        assert t[:3] == j[:3]
        np.testing.assert_allclose(t[3:], j[3:], atol=ATOL)


def test_coronal_recon_matches(both):
    j = jsr.coronal_recon(both["jres"], None, both["jcfg"], transverse_length=6)
    t = tsr.coronal_recon(both["tres"], both["tcfg"], transverse_length=6)
    assert t.shape == j.shape == (32, 32, 6, 1)
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_adc_maps_match(both):
    for t, j in zip(tsr.adc_maps(both["tres"], both["tcfg"], 1),
                    jsr.adc_maps(both["jres"], both["jcfg"], 1)):
        np.testing.assert_allclose(t, j, atol=1e-4)


def test_cli_preset_runs_grid_on_cpu(hybrid, tmp_path):
    """``--preset quality`` and ``--preset fast`` reach the grid branch
    through the CLI, which writes the CSV and timings.json."""
    import json
    import os

    from mri_super_resolution_tpu.data import save_mat
    from mri_super_resolution_tpu_torch.cli import superres_dwi as tcli

    mat = np.empty((4, 4), dtype=object)
    for b in range(4):
        for te in range(4):
            mat[b, te] = hybrid[b][te]
    path = str(tmp_path / "p1" / "master.mat")
    save_mat(path, {"hybrid_raw": mat, "b": BVALUES[None, :]})
    for preset, pn in (("quality", "2"), ("fast", "0")):
        out = str(tmp_path / preset)
        tcli.main(["--master_mats", path, "--preset", preset, "--epochs", "4",
                   "--pn_epochs", pn, "--grid_levels", "2", "--grid_base_resolution", "4",
                   "--grid_hidden", "8", "--roi_start", "4", "--roi_end", "20",
                   "--device", "cpu", "--out", out])
        lines = open(os.path.join(out, "patp1", "ssim_scores.csv")).read().splitlines()
        assert len(lines) == 1 + 3 * 4
        cfg = json.load(open(os.path.join(out, "timings.json")))["config"]
        assert cfg["inr_model"] == "grid" and cfg["inr_restart_every"] == 250
        assert cfg["epochs"] == 4 and cfg["pn_epochs"] == int(pn)
