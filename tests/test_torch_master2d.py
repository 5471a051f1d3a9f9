"""The port's 2-D directional ensemble (master.py) against the JAX package's:
``fit_ensemble`` (the port's ``fit_ensemble_batched`` at one direction) and
``fit_directions`` from the same initial params (the
JAX package's own, reproduced from master2d.py:131-132 and converted),
``run_case`` + ``save_case_outputs``, and ``cli/master.py`` end to end on
the CPU.

The port's per-acquisition updates run the plain K1 with sample weights,
the JAX package's (off the TPU) autodiff of the same loss: float32 in
another order, so the loss trace agrees to rtol 1e-5 and the ensemble
predictions to atol 1e-5 over these few steps. Images derived from them
inherit that: each within 1e-4 of its own largest magnitude (the ADC's log
and x1e6 and the min-max stretch amplify the predictions' rounding).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.io as sio
import torch

from mri_super_resolution_tpu.config import Master2DConfig as JConfig
from mri_super_resolution_tpu.core.coords import mgrid as jmgrid
from mri_super_resolution_tpu.data import Case as JCase
from mri_super_resolution_tpu.data import CONTRAST_HEADER as J_HEADER
from mri_super_resolution_tpu.data import MetricsCSV as JCSV
from mri_super_resolution_tpu.fit.engine import fit_ensemble as j_fit_ensemble
from mri_super_resolution_tpu.models import Siren as JSiren
from mri_super_resolution_tpu.pipelines import master2d as jm2d
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.cli import master as master_cli
from mri_super_resolution_tpu_torch.config import Master2DConfig
from mri_super_resolution_tpu_torch.core.coords import mgrid
from mri_super_resolution_tpu_torch.data import CONTRAST_HEADER, Case, MetricsCSV
from mri_super_resolution_tpu_torch.fit.engine import fit_ensemble_batched
from mri_super_resolution_tpu_torch.fit.optim import StackedAdam
from mri_super_resolution_tpu_torch.ops import siren_kernel as tk
from mri_super_resolution_tpu_torch.pipelines import master2d

torch.set_num_threads(2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_init_stack(cfg, H, W, D, seed):
    """master2d.py:124-132 of the JAX package: the D directions' initial
    params, converted to the port's weight lists."""
    model = JSiren(hidden_features=cfg.hidden_features, hidden_layers=cfg.hidden_layers,
                   out_features=1)
    coords = jmgrid((H, W))
    keys = jax.random.split(jax.random.key(seed), D)
    stack = jax.vmap(lambda k: model.init(k, coords[:4]))(keys)
    return model, stack, convert.siren_stack_weights(_np(stack))


def test_fit_ensemble_matches_jax_with_padded_slots():
    """One direction with 2 real and 2 padded slots (tests/test_master2d.py's
    unequal-count case): the JAX fit masks the padded slots, the port skips
    them. Loss trace, 1x and scale-x predictions, final params."""
    rng = np.random.default_rng(0)
    H = W = 9
    cfg = JConfig(hidden_features=16, hidden_layers=1, total_steps=6, seg=2, scale=2)
    model, stack, tws = _jax_init_stack(cfg, H, W, 1, seed=3)
    params = jax.tree.map(lambda a: a[0], stack)
    pix = np.zeros((4, H * W, 1), np.float32)
    w = np.zeros((4, H * W, 1), np.float32)
    pix[:2] = rng.uniform(-1, 1, size=(2, H * W, 1))
    w[:2] = (rng.uniform(size=(2, H * W, 1)) > 0.2)
    valid = np.array([True, True, False, False])
    coords, coords_s = jmgrid((H, W)), jmgrid((2 * H, 2 * W))
    ref = j_fit_ensemble(model.apply, optax.adam(cfg.learning_rate), params, coords,
                         jnp.asarray(pix), jnp.asarray(w), coords, coords_s,
                         total_steps=cfg.total_steps, seg=cfg.seg, valid=jnp.asarray(valid))
    siren_w = [t.clone()[None] for t in tws[0]]  # one direction: D = 1
    res = fit_ensemble_batched(
        lambda p, x: tk.siren_forward_batched_ref(x, p), StackedAdam(siren_w, cfg.learning_rate),
        mgrid((H, W)), torch.as_tensor(pix)[None], torch.as_tensor(w)[None], mgrid((H, W)),
        mgrid((2 * H, 2 * W)), cfg.total_steps, cfg.seg, valid=valid[None],
        weighted_value_and_grad_fn=lambda p, x, t, sw: tk.siren_loss_grads_batched(
            x, p, t, sample_weights=sw))
    np.testing.assert_allclose(res.losses[:, 0].numpy(), np.asarray(ref.losses), rtol=1e-5)
    np.testing.assert_allclose(res.pred_1x[0].numpy(), np.asarray(ref.pred_1x), atol=1e-5)
    np.testing.assert_allclose(res.pred_scale[0].numpy(), np.asarray(ref.pred_scale),
                               atol=1e-5)
    final = convert.siren_weights(_np(ref.params))
    for a, b in zip(res.params, final):
        np.testing.assert_allclose(a[0].numpy(), b.numpy(), atol=1e-5)


def test_fit_directions_matches_jax_unequal_counts():
    """The JAX package's vmapped, padded three-direction fit against the
    port's batched one (the three directions stacked, the padded slots
    masked in the stacked Adam) from the same initial params."""
    rng = np.random.default_rng(1)
    H, W = 8, 10
    counts = (3, 1, 2)
    roi = rng.uniform(0.2, 1.0, size=(H, W, sum(counts))).astype(np.float32)
    accept = (rng.uniform(size=roi.shape) > 0.25).astype(np.float32)
    jcfg = JConfig(hidden_features=16, hidden_layers=1, total_steps=5, seg=2, scale=2)
    _, _, stack = _jax_init_stack(jcfg, H, W, len(counts), seed=0)
    want_1x, want_s = jm2d.fit_directions(roi, accept, counts, jcfg, 0)
    cfg = Master2DConfig(hidden_features=16, hidden_layers=1, total_steps=5, seg=2, scale=2)
    got_1x, got_s = master2d.fit_directions(roi, accept, counts, cfg, 0, device="cpu",
                                            params_stack=stack)
    np.testing.assert_allclose(got_1x, want_1x, atol=1e-5)
    np.testing.assert_allclose(got_s, want_s, atol=1e-5)


def _tiny_case(case_cls, seed=0):
    """tests/test_master2d.py's tiny case (32 x 32 x 4, 2 acquisitions per
    direction), one acquisition of direction x dark inside the ROI so that
    AutoERD rejects it."""
    rng = np.random.default_rng(seed)
    H = W = 32
    S, A = 4, 6
    b0 = rng.uniform(0.5, 1.5, size=(H, W, S)).astype(np.float32)
    base = rng.uniform(0.2, 1.0, size=(H, W, S)).astype(np.float32)
    dwi = np.stack([base + 0.02 * rng.normal(size=(H, W, S)).astype(np.float32)
                    for _ in range(A)], axis=-1).astype(np.float32)
    dwi[8:24, 8:24, 1, 0] = 0.01
    return case_cls(pt_id="00-0000-99", b=900.0, cancer_loc=(18, 18),
                    contralateral_loc=(14, 14), noise=(22, 22), cancer_slice=1,
                    acquisitions=(2, 2, 2), dwi=dwi, b0=b0,
                    erd=np.ones((H, W, S), dtype=np.float32),
                    accept=np.ones(dwi.shape, dtype=np.int32), synthetic_dwi=True)


def _close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale, err_msg=what)


def test_run_case_and_outputs_match_jax(tmp_path):
    kw = dict(total_steps=6, seg=2, hidden_layers=1, hidden_features=16, roi_begin=8,
              roi_end=24, scale=2, exp_name="t", erd=1)
    jcfg = JConfig(out_folder=str(tmp_path / "jexp"), out_img_folder=str(tmp_path / "jimg"),
                   **kw)
    cfg = Master2DConfig(out_folder=str(tmp_path / "exp"),
                         out_img_folder=str(tmp_path / "img"), **kw)
    jcase, case = _tiny_case(JCase), _tiny_case(Case)
    jcsv = JCSV(str(tmp_path / "j.csv"), J_HEADER)
    csv = MetricsCSV(str(tmp_path / "t.csv"), CONTRAST_HEADER)
    want = jm2d.run_case(jcase, jcfg, seed=0, csv=jcsv)
    jm2d.save_case_outputs(want, jcase, jcfg, 0, jcsv)
    _, _, stack = _jax_init_stack(jcfg, 16, 16, 3, seed=0)
    got = master2d.run_case(case, cfg, 0, csv, device="cpu", params_stack=stack)
    master2d.save_case_outputs(got, case, cfg, 0, csv)
    np.testing.assert_array_equal(case.accept, jcase.accept)  # AutoERD's mask
    assert case.accept[8:24, 8:24, 1, 0].mean() < 0.3
    assert set(got) == set(want) == {"x", "y", "z"}
    for d in want:
        for f in dataclasses.fields(master2d.DirectionOutputs):
            _close(getattr(got[d], f.name), getattr(want[d], f.name), f"{d}.{f.name}")
    rows_j = [ln.split(",") for ln in open(jcsv.path).read().splitlines()]
    rows_t = [ln.split(",") for ln in open(csv.path).read().splitlines()]
    assert rows_t[0] == rows_j[0] == list(CONTRAST_HEADER)
    assert len(rows_t) == len(rows_j) == 1 + 4 * 8 * 3
    assert [r[:5] for r in rows_t] == [r[:5] for r in rows_j]
    np.testing.assert_allclose([float(r[5]) for r in rows_t[1:]],
                               [float(r[5]) for r in rows_j[1:]], rtol=1e-3, atol=1e-6)
    for sub, n in (("DWI", 4), ("ADC", 6)):
        assert sorted(os.listdir(tmp_path / "img" / "t" / "99" / sub)) == sorted(
            os.listdir(tmp_path / "jimg" / "t" / "99" / sub))
        assert len(os.listdir(tmp_path / "img" / "t" / "99" / sub)) == n


def test_master_cli_on_cpu(tmp_path):
    """cli/master.py end to end on one registry patient (synthetic
    acquisitions from a small mean-b0 volume), AutoERD mode 1."""
    rng = np.random.default_rng(0)
    data = tmp_path / "data"
    data.mkdir()
    sio.savemat(data / "pat07_mean_b0.mat",
                {"data_mean_b0": rng.uniform(20, 60, (24, 24, 12)).astype(np.float32)})
    sio.savemat(data / "pat07_ERD.mat",
                {"ADC_alldata_mm_ERD": rng.uniform(0, 3, (24, 24, 12)).astype(np.float32)})
    tk.reset_launches()
    path = master_cli.main([
        "--out_folder", str(tmp_path / "exp"), "--out_img_folder", str(tmp_path / "img"),
        "--total_steps", "3", "--seg", "2", "--hidden_layers", "1", "--hidden_features",
        "16", "--ROI_begin", "4", "--ROI_end", "20", "--scale", "2", "--exp_name", "e",
        "--erd", "1", "--limit_cases", "1", "--data_dir", str(data), "--device", "cpu"])
    lines = open(path).read().splitlines()
    assert lines[0] == ",".join(CONTRAST_HEADER) and len(lines) == 1 + 4 * 8 * 3
    assert all(np.isfinite(float(ln.split(",")[5])) or "nan" in ln for ln in lines[1:])
    assert len(os.listdir(tmp_path / "img" / "e" / "07" / "DWI")) == 4
    assert len(os.listdir(tmp_path / "img" / "e" / "07" / "ADC")) == 6
    assert not any(tk.LAUNCHES.values())
    with pytest.raises(ValueError, match="use_pallas"):  # no autograd route on the card
        master2d.run(dataclasses.replace(Master2DConfig(), use_pallas=False), [],
                     device="cuda")
