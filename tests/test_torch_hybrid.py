"""The port's hybrid multi-TE tissue fit (``pipelines/hybrid.py``) and its
two CLIs against the JAX package's, on the CPU.

A tiny patient (mono-exponential synthetic hybrid of a 20x20x2 b0, ROI
2:18, so an 8x8x2x4 LR grid a TE) runs through both ``fit_all_te``s in
each arm: ``siren`` (FF-SIREN 16 -> 32x2 -> 1, 25 epochs; the port runs
the plain batched K1 where the JAX package takes autodiff on the CPU),
``grid`` (GridINR 2 levels, base 4, F 2, hidden 8; 30 epochs, restarts
every 10; the four TEs one batched fit in both packages) and
``grid_shared`` (the same GridINR over 16 (b, TE) slots; 40 epochs, restarts
every 20). The port gets the JAX-drawn B and initial params (converted)
through ``init=``; the JAX loss traces are read from its fit programs.

Measured gaps: loss traces 2.4e-7 relative (siren), 3.6e-7 (grid), 2.4e-7
(grid_shared); recon_hybrid 4.5e-7 (siren, values up to 0.51), 2.4e-7
(grid, up to 1.07; 3.0e-7 when the port fitted the TEs in turn), 2.4e-7
(grid_shared, up to 1.08). Tolerances: 1e-5
relative on the traces, 1e-5 absolute on the recon.

``tissue_maps`` runs on each arm's JAX-made recon in both packages. With
the NLLS: this mono-exponential phantom does not identify the three
compartments, so LM lanes part more often than on the tissue phantom of
``tests/test_torch_nlls_pids.py``; measured over the six slices, 97.4-99.8%
of the voxels within 1e-4 of each parameter's bound range, at least 99.8%
within 1e-3, the worst voxel 1.2e-2; the ADC 3.6e-7; the cancer maps equal.
Tolerances: at least 95% within 1e-4, 99% within 1e-3, every voxel within
5e-2, the ADC 1e-5, at least 98% of the cancer map equal. With a PIA
fitter of converted params: maps 1.7e-6 relative, tolerance 1e-5 relative
(1e-6 absolute).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.core.coords import fourier_encode, fourier_matrix, mgrid
from mri_super_resolution_tpu.data import save_mat
from mri_super_resolution_tpu.fit import engine as jengine
from mri_super_resolution_tpu.models import Siren as JSiren
from mri_super_resolution_tpu.models import pia as jpia
from mri_super_resolution_tpu.pipelines import hybrid as jhy
from mri_super_resolution_tpu.pipelines import pia_train as jtrain
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.cli import pia as pia_cli
from mri_super_resolution_tpu_torch.cli import superres_hybrid as hy_cli
from mri_super_resolution_tpu_torch.data import synthetic
from mri_super_resolution_tpu_torch.ops.nlls import HI, LO
from mri_super_resolution_tpu_torch.pipelines import hybrid as thy

torch.set_num_threads(2)

BV = np.asarray([0.0, 150.0, 1000.0, 1500.0])
ROI = dict(roi_start_x=2, roi_end_x=18, roi_start_y=2, roi_end_y=18)
GRID = dict(grid_levels=2, grid_base_resolution=4, grid_features=2, grid_hidden=8)
ARMS = {
    "siren": dict(ROI, number_of_epochs=25, hidden_dim=32, num_layers=1, mapping_size=8),
    "grid": dict(ROI, **GRID, number_of_epochs=30, inr_model="grid", inr_restart_every=10),
    "grid_shared": dict(ROI, **GRID, number_of_epochs=40, inr_model="grid_shared",
                        inr_restart_every=20),
}
LR_SHAPE = (8, 8, 2, 4)
TRACE_RTOL, ATOL, MAPS_RTOL = 1e-5, 1e-5, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_init(cfg, seed=0):
    """B and the initial params as the JAX fit_all_te draws them."""
    key = jax.random.key(seed)
    if cfg.inr_model == "grid_shared":
        p = jhy._hybrid_grid_model(cfg, num_b=16).init(key, mgrid(LR_SHAPE[:3] + (16,))[:8])
        return {"inr": convert.grid_inr_from_flax(_np(p))}
    kB, kI = jax.random.split(key)
    B = fourier_matrix(kB, cfg.mapping_size, 4, scale=cfg.ff_scale)
    keys = jax.random.split(kI, 4)
    if cfg.inr_model == "grid":
        m = jhy._hybrid_grid_model(cfg)
        ps = [m.init(k, mgrid(LR_SHAPE)[:8]) for k in keys]
        return {"B": np.array(B), "inr": [convert.grid_inr_from_flax(_np(p)) for p in ps]}
    m = JSiren(hidden_features=cfg.hidden_dim, hidden_layers=cfg.num_layers)
    ff = fourier_encode(mgrid(LR_SHAPE), B)
    ps = [m.init(k, ff[:8]) for k in keys]
    return {"B": np.array(B), "inr": [convert.siren_state_dict(_np(p)) for p in ps]}


@pytest.fixture(scope="module")
def hybrid():
    rng = np.random.default_rng(0)
    b0 = np.abs(rng.normal(1.0, 0.2, (20, 20, 2))).astype(np.float32)
    return jhy.mean_over_acquisitions(
        synthetic.hybrid_from_b0(b0, acq_counts=(1, 2, 2, 2), seed=0))


def _run_jax(hybrid, cfg):
    """The JAX fit_all_te and its loss traces, (fits, epochs)."""
    traces = []
    mp = pytest.MonkeyPatch()
    make_stack, fit_simple = jhy._make_fit_stack, jengine.fit_simple

    def stack(*a):
        run = make_stack(*a)

        def recorded(*b):
            fitted, losses = run(*b)
            traces.append(np.asarray(losses))
            return fitted, losses

        return recorded

    def simple(*a, **k):
        res = fit_simple(*a, **k)
        traces.append(np.asarray(res.losses)[None])
        return res

    mp.setattr(jhy, "_make_fit_stack", stack)
    mp.setattr(jengine, "fit_simple", simple)
    try:
        res = jhy.fit_all_te(hybrid, cfg, seed=0)
    finally:
        mp.undo()
    (losses,) = traces
    return res, losses


@pytest.fixture(scope="module", params=sorted(ARMS))
def arm(request, hybrid):
    jcfg, tcfg = jhy.HybridConfig(**ARMS[request.param]), thy.HybridConfig(**ARMS[request.param])
    jres, jlosses = _run_jax(hybrid, jcfg)
    tres = thy.fit_all_te(hybrid, tcfg, seed=0, device="cpu", init=_jax_init(jcfg))
    return dict(name=request.param, jres=jres, tres=tres, jlosses=jlosses)


def test_fit_all_te_loss_traces_match(arm):
    j, t = arm["jlosses"], arm["tres"].losses
    fits = 1 if arm["name"] == "grid_shared" else 4
    assert t.shape == j.shape == (fits, ARMS[arm["name"]]["number_of_epochs"])
    np.testing.assert_allclose(t, j, rtol=TRACE_RTOL, atol=0)
    assert (t[:, -1] < t[:, 0]).all()


def test_fit_all_te_recon_matches(arm):
    jres, tres = arm["jres"], arm["tres"]
    assert tres.recon_hybrid.shape == jres.recon_hybrid.shape == (32, 32, 2, 4, 4)
    assert (tres.recon_hybrid >= 0).all()
    np.testing.assert_allclose(tres.recon_hybrid, jres.recon_hybrid, atol=ATOL)
    np.testing.assert_array_equal(tres.maxes, jres.maxes)
    assert tres.timings["inr_model"] == arm["name"] and tres.timings["platform"] == "cpu"
    assert tres.timings["lr_voxels_per_te"] == jres.timings["lr_voxels_per_te"] == 512


@pytest.fixture(scope="module")
def recon(arm):
    return arm["jres"]


@pytest.mark.parametrize("_slice", [0, 1])
def test_tissue_maps_nlls_match(recon, _slice):
    j = jhy.tissue_maps(recon, BV, _slice=_slice, nlls_iters=20)
    t = thy.tissue_maps(thy.HybridResult(recon.recon_hybrid, recon.maxes), BV,
                        _slice=_slice, nlls_iters=20, device="cpu")
    jt = np.concatenate([j.D, j.T2, j.v[..., :2]], -1).reshape(-1, 8)
    tt = np.concatenate([t.D, t.T2, t.v[..., :2]], -1).reshape(-1, 8)
    per_voxel = (np.abs(tt - jt) / (HI - LO)).max(-1)
    assert (per_voxel < 1e-4).mean() >= 0.95 and (per_voxel < 1e-3).mean() >= 0.99
    assert per_voxel.max() < 5e-2
    np.testing.assert_allclose(t.v.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(t.adc, j.adc, atol=1e-5)
    assert t.cancer.dtype == bool and (t.cancer == j.cancer).mean() >= 0.98


def test_tissue_maps_pia_fitter_matches(hybrid, tmp_path):
    jm = jpia.PIA()
    p = jm.init(jax.random.key(3), jnp.zeros((2, 16)))
    path = str(tmp_path / "pia.pt")
    torch.save(convert.pia_from_flax(_np(p)), path)
    rh = np.random.default_rng(4).uniform(10, 1000, (8, 8, 2, 4, 4)).astype(np.float32)
    result = thy.HybridResult(recon_hybrid=rh, maxes=np.ones((4, 4)))
    j = jhy.tissue_maps(jhy.HybridResult(rh, np.ones((4, 4))), BV, _slice=1,
                        fitter=lambda s: jtrain.predict_maps(jm, p, jnp.asarray(s)))
    t = thy.tissue_maps(result, BV, _slice=1, device="cpu",
                        fitter=thy.make_pia_fitter(params_path=path, device="cpu"))
    for a, b in ((t.D, j.D), (t.T2, j.T2), (t.v, j.v)):
        assert a.shape == (8, 8, 3)
        np.testing.assert_allclose(a, b, rtol=MAPS_RTOL, atol=1e-6)
    np.testing.assert_array_equal(t.cancer, j.cancer)
    # a fresh fitter trains on synthetic draws first
    fresh = thy.make_pia_fitter(train_steps=3, device="cpu")
    maps = thy.tissue_maps(result, BV, _slice=0, device="cpu", fitter=fresh)
    np.testing.assert_allclose(maps.v.sum(-1), 1.0, atol=1e-5)


def test_remove_small_objects_matches():
    rng = np.random.default_rng(5)
    for p in (0.3, 0.5, 0.0):
        mask = rng.uniform(size=(30, 30)) < p
        got = thy.remove_small_objects(mask, min_size=4)
        np.testing.assert_array_equal(got, jhy.remove_small_objects(mask, min_size=4))
        assert got.dtype == bool and (got <= mask).all()
    mask = np.zeros((10, 10), bool)
    mask[0:4, 0:4] = True
    mask[8, 8] = True
    out = thy.remove_small_objects(mask, min_size=12)
    assert out[1, 1] and not out[8, 8]


def test_clis_end_to_end_on_cpu(hybrid, tmp_path):
    """pia: pretrain, fine-tune on voxels, maps, a torch.save state dict;
    superres_hybrid: a master.mat patient with the NLLS and with that PIA."""
    voxels = str(tmp_path / "vox.npz")
    np.savez(voxels, signals=np.random.default_rng(6).uniform(0, 1000, (20, 16)))
    ckpt, maps_out = str(tmp_path / "pia" / "model.pt"), str(tmp_path / "maps.npz")
    pia_cli.main(["--steps", "3", "--batch_size", "8", "--finetune_hybrid", voxels,
                  "--finetune_steps", "2", "--maps_out", maps_out, "--out", ckpt,
                  "--device", "cpu"])
    assert set(torch.load(ckpt)) == set(thy.PIA().state_dict())
    assert np.load(maps_out)["v"].shape == (20, 3)

    mat = np.empty((4, 4), dtype=object)
    for b in range(4):
        for te in range(4):
            mat[b, te] = hybrid[b][te]
    path = str(tmp_path / "p1" / "master.mat")
    save_mat(path, {"hybrid_raw": mat, "b": BV[None, :]})
    base = ["--master_mats", path, "--epochs", "3", "--hidden_dim", "16", "--num_layers",
            "1", "--mapping_size", "8", "--roi_start", "2", "--roi_end", "18",
            "--nlls_iters", "5", "--device", "cpu"]
    for fit in (["--tissue_fit", "nlls", "--slices", "0", "1"],
                ["--tissue_fit", "pia", "--pia_ckpt", ckpt, "--preset", "fast"]):
        out = str(tmp_path / fit[1])
        hy_cli.main(base + fit + ["--out", out])
        timings = json.load(open(os.path.join(out, "timings.json")))
        row = timings["patients"][0]
        assert row["pt_id"] == "p1" and row["tissue_fit"] == fit[1]
        assert row["platform"] == "cpu" and row["total_s"] > 0
        for s in (fit[3:] if fit[1] == "nlls" else ["1"]):
            maps = np.load(os.path.join(out, "patp1", f"maps_slice_{s}.npz"))
            assert maps["D"].shape == (32, 32, 3) and maps["cancer"].dtype == bool
        assert not any(f.endswith(".png") for f in os.listdir(os.path.join(out, "patp1")))
    assert timings["config"]["inr_model"] == "grid"  # the fast preset


def test_cuda_requested_without_a_card_raises(hybrid, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = thy.HybridConfig(**ARMS["grid"])
    with pytest.raises(RuntimeError, match="cuda"):
        thy.fit_all_te(hybrid, cfg)
    result = thy.HybridResult(np.ones((4, 4, 2, 4, 4), np.float32), np.ones((4, 4)))
    with pytest.raises(RuntimeError, match="cuda"):
        thy.tissue_maps(result, BV, _slice=0)
    with pytest.raises(RuntimeError, match="cuda"):
        thy.make_pia_fitter(train_steps=1)
    with pytest.raises(RuntimeError, match="cuda"):
        pia_cli.main(["--steps", "1", "--out", str(tmp_path / "m.pt")])
    with pytest.raises(ValueError, match="unknown inr_model"):
        thy.fit_all_te(hybrid, thy.HybridConfig(inr_model="wire"), device="cpu")
