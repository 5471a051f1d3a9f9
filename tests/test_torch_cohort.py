"""The port's cohort runner against the JAX package's: ``run_cohort`` on the
24 x 24 cases of ``tests/test_cohort.py`` from the JAX package's per-case
params (converted with ``convert.py``), in one process and on 2 gloo ranks
(one case axis of 2), with plain Adam and with moment restarts; and the
``cohort_run`` CLI end to end on the CPU.

Tolerances: losses atol 2e-5 and reconstructions atol 5e-4 (float32 sums in
another order through Adam; the JAX package's own bar between its fit
routes).
"""
import os
import re

import jax
import numpy as np
import pytest
import scipy.io as sio
import torch

from mri_super_resolution_tpu.core.coords import mgrid as jmgrid
from mri_super_resolution_tpu.data import Case as JCase
from mri_super_resolution_tpu.models import Siren as JSiren
from mri_super_resolution_tpu.pipelines import cohort as jcohort
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.cli import cohort_run
from mri_super_resolution_tpu_torch.data import Case
from mri_super_resolution_tpu_torch.parallel.distributed import spawn_ranks
from mri_super_resolution_tpu_torch.pipelines import cohort

torch.set_num_threads(2)

KW = dict(num_steps=20, hidden_features=16, hidden_layers=1, roi=(4, 20))
LOSS_ATOL, RECON_ATOL = 2e-5, 5e-4


def _case_kwargs(rng, pt):
    """tests/test_cohort.py:_mk_case's case."""
    H = W = 24
    S, A = 2, 3
    b0 = rng.uniform(0.5, 1.5, size=(H, W, S)).astype(np.float32)
    dwi = np.stack([0.5 * b0 + 0.02 * rng.normal(size=(H, W, S)).astype(np.float32)
                    for _ in range(A)], axis=-1).astype(np.float32)
    return dict(pt_id=f"00-0000-{pt}", b=900.0, cancer_loc=(12, 12), contralateral_loc=(8, 8),
                noise=(18, 18), cancer_slice=1, acquisitions=(1, 1, 1), dwi=dwi, b0=b0,
                erd=np.ones((H, W, S), np.float32), accept=np.ones(dwi.shape, np.int32),
                synthetic_dwi=True)


def _jax_init(C, seed=0):
    """run_cohort's per-case inits (cohort.py:71-75), converted."""
    model = JSiren(hidden_features=16, hidden_layers=1, out_features=1)
    coords = jmgrid((16, 16))
    return [[w.numpy() for w in convert.siren_weights(
        jax.tree.map(np.asarray, model.init(k, coords[:4])))]
        for k in jax.random.split(jax.random.key(seed), C)]


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(0)
    return [_case_kwargs(rng, p) for p in ("01", "02", "03", "04")]


def _check(got, want):
    np.testing.assert_allclose(got.losses, np.asarray(want.losses), rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(got.recons, np.asarray(want.recons), rtol=0, atol=RECON_ATOL)


@pytest.mark.parametrize("every", [0, 10])
def test_run_cohort_matches_jax(cases, every):
    """Four cases in one batched program against the JAX runner (its case
    axis 4 on the 8-device virtual mesh)."""
    want = jcohort.run_cohort([JCase(**k) for k in cases], inr_restart_every=every, **KW)
    got = cohort.run_cohort([Case(**k) for k in cases], inr_restart_every=every,
                            init_params=[[torch.as_tensor(w) for w in ws]
                                         for ws in _jax_init(4)], device="cpu", **KW)
    assert got.recons.shape == (4, 16, 16) and got.losses.shape == (4, 20)
    assert got.mesh_shape == {"case": 1, "data": 1} and want.mesh_shape["case"] == 4
    assert (got.losses[:, -1] < got.losses[:, 0]).all() and got.voxels_per_sec > 0
    _check(got, want)


def test_run_cohort_on_two_ranks_matches_jax(cases):
    """Two ranks, a case axis of 2: each rank fits two cases and returns
    all four."""
    want = jcohort.run_cohort([JCase(**k) for k in cases], **KW)
    got = spawn_ranks(_worker().run_cohort, 2, cases, _jax_init(4), KW, timeout=300)
    for r in got:
        assert r["mesh_shape"] == {"case": 2, "data": 1}
        np.testing.assert_allclose(r["losses"], np.asarray(want.losses), rtol=0,
                                   atol=LOSS_ATOL)
        np.testing.assert_allclose(r["recons"], np.asarray(want.recons), rtol=0,
                                   atol=RECON_ATOL)
    np.testing.assert_array_equal(got[0]["recons"], got[1]["recons"])


def _worker():
    import _torch_parallel_worker

    return _torch_parallel_worker


def test_single_case_and_seeded_init(cases):
    """One case: a mesh of one; without ``init_params`` each case draws its
    Siren from its own generator seed, the same for the same seed."""
    a = cohort.run_cohort([Case(**cases[0])], device="cpu", **{**KW, "num_steps": 3})
    b = cohort.run_cohort([Case(**cases[0])], device="cpu", **{**KW, "num_steps": 3})
    assert a.recons.shape == (1, 16, 16) and a.mesh_shape["case"] == 1
    np.testing.assert_array_equal(a.losses, b.losses)
    assert len(set(cohort.case_seeds(0, 4))) == 4 and cohort.case_seeds(0, 2) == \
        cohort.case_seeds(0, 4)[:2]


def test_cohort_run_cli(tmp_path, capsys):
    """cohort_run on two registry patients (100 x 100 x 12 mean-b0 volumes,
    the default ROI 40:100), with a TensorBoard directory."""
    rng = np.random.default_rng(2)
    for no in ("07", "08"):
        sio.savemat(tmp_path / f"pat{no}_mean_b0.mat", {"data_mean_b0": rng.uniform(
            0.5, 1.5, (100, 100, 12)).astype(np.float32)})
        sio.savemat(tmp_path / f"pat{no}_ERD.mat", {"ADC_alldata_mm_ERD": np.ones(
            (100, 100, 12), np.float32)})
    res = cohort_run.main(["--steps", "3", "--hidden_features", "16", "--hidden_layers", "1",
                           "--data_dir", str(tmp_path), "--device", "cpu",
                           "--tensorboard_dir", str(tmp_path / "tb"), "--inr_restart_every",
                           "2"])
    out = capsys.readouterr().out
    assert res.losses.shape == (2, 3) and res.recons.shape == (2, 60, 60)
    assert np.isfinite(res.recons).all()
    assert re.search(r"cohort of 2 cases on mesh \{'case': 1, 'data': 1\}: [\d,]+ voxels/sec", out)
    for pt in ("18-1681-07", "18-1681-08"):
        assert any(f.startswith("events.out.tfevents")
                   for f in os.listdir(tmp_path / "tb" / pt))
    with pytest.raises(SystemExit):
        cohort_run.main(["--data_dir", str(tmp_path / "empty"), "--device", "cpu"])
