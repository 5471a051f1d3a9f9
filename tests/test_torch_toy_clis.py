"""The toy fits (inr_toy.py, automate_INR.py) on the port against the JAX
package: ``SirenToy`` with and without its perturbation branch on converted
params, a short ``fit_simple`` trace of ``inr_toy``'s fit from one init,
the ``inr_toy`` and ``automate_inr`` CLIs on the CPU, and ``save_mat``.

Both packages fit these by autodiff of the plain model (no kernel). The
forward is float32 in another order: 1e-5 absolute, as the soft-ERD
model's test. The fit trace holds the loss to rtol 1e-5 and the params to
atol 1e-5 over 30 Adam steps, the bars of ``tests/test_torch_inr_erd.py``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.io as sio
import torch

from mri_super_resolution_tpu.core.coords import mgrid as jmgrid
from mri_super_resolution_tpu.fit.engine import fit_simple as j_fit_simple
from mri_super_resolution_tpu.models import SirenToy as JSirenToy
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.cli import automate_inr as automate_cli
from mri_super_resolution_tpu_torch.cli import inr_toy as toy_cli
from mri_super_resolution_tpu_torch.core.coords import mgrid
from mri_super_resolution_tpu_torch.data import save_mat
from mri_super_resolution_tpu_torch.fit.engine import fit_simple, plain_apply
from mri_super_resolution_tpu_torch.fit.optim import Adam
from mri_super_resolution_tpu_torch.models import SirenToy
from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

torch.set_num_threads(2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(params, hidden, layers, perturb):
    m = SirenToy(2, hidden, layers, perturb=perturb)
    m.load_state_dict(convert.siren_toy_state_dict(_np(params)))
    m.requires_grad_(False)
    return m


@pytest.mark.parametrize("perturb", [False, True])
def test_siren_toy_matches_flax(perturb):
    jmodel = JSirenToy(hidden_features=16, hidden_layers=2, perturb=perturb)
    coords = jmgrid((9, 7))
    params = jmodel.init(jax.random.key(3), coords, 0.0, 0.0)
    model = _port(params, 16, 2, perturb)
    assert (model.perturb is not None) == perturb
    assert len(model.state_dict()) == 8 + (4 if perturb else 0)
    for sample, eps in ((0.0, 0.0), (2.0, 0.1), (5.0, 1.0)):
        want = np.asarray(jmodel.apply(params, coords, sample, eps))
        got = model(torch.as_tensor(np.array(coords)), sample, eps).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_inr_toy_fit_trace_matches_jax():
    """inr_toy's fit: 30 Adam steps at its lr from one init, in two chunks
    (the moments carried across), the loss step by step."""
    side, lr = 12, 3e-4
    img = np.random.default_rng(0).uniform(0.2, 1.0, size=(side, side)).astype(np.float32)
    jmodel = JSirenToy(hidden_features=16, hidden_layers=1)
    coords = jmgrid((side, side))
    params = jmodel.init(jax.random.key(1), coords)
    model = _port(params, 16, 1, False)  # before fit_simple donates params
    tx = optax.adam(lr)
    target = jnp.asarray(img.reshape(-1, 1))
    r1 = j_fit_simple(jmodel.apply, tx, params, coords, target, 20)
    r2 = j_fit_simple(jmodel.apply, tx, r1.params, coords, target, 10, opt_state=r1.opt_state)
    want = np.concatenate([np.asarray(r1.losses), np.asarray(r2.losses)])

    apply_fn = plain_apply(model)
    opt = Adam(model.weights(), lr)
    x, t = mgrid((side, side)), torch.as_tensor(img.reshape(-1, 1))
    got = torch.cat([fit_simple(apply_fn, opt, x, t, 20).losses,
                     fit_simple(apply_fn, opt, x, t, 10).losses]).numpy()
    assert want[-1] < 0.8 * want[0]  # the fit moves
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for a, b in zip(model.weights(), _port(r2.params, 16, 1, False).weights()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_inr_toy_cli_on_cpu(tmp_path):
    out = str(tmp_path / "m" / "toy.pt")
    sk.reset_launches()
    mse = toy_cli.main(["--side", "16", "--num_acq", "3", "--hidden_features", "16",
                        "--hidden_layers", "1", "--check_every", "20", "--max_steps", "60",
                        "--out", out, "--device", "cpu"])
    assert np.isfinite(mse) and mse < 0.1
    assert not any(sk.LAUNCHES.values())
    model = SirenToy(2, 16, 1)
    model.load_state_dict(torch.load(out))


@pytest.mark.parametrize("use_pn,snapshots", [(False, 4), (True, 5)])
def test_automate_inr_cli_on_cpu(tmp_path, use_pn, snapshots):
    """30 epochs in snapshots of 8: 8, 16, 24, 30; with the PerturbNet the
    mean phase is cut at its 10th epoch (8, 10), then 18, 26, 30."""
    out = str(tmp_path / "auto.mat")
    sk.reset_launches()
    path = automate_cli.main(["--side", "12", "--num_acq", "3", "--mapping_size", "8",
                              "--hidden", "16", "--layers", "1", "--epochs", "30",
                              "--mean_epochs", "10", "--snapshot_every", "8", "--out", out,
                              "--device", "cpu", *(["--use_pn"] if use_pn else [])])
    assert path == out and not any(sk.LAUNCHES.values())
    data = sio.loadmat(out)
    assert data["recon"].shape == (12, 12)
    assert data["sr_epochs"].shape == (12, 12, snapshots)
    np.testing.assert_array_equal(data["sr_epochs"][..., -1], data["recon"])
    assert np.isfinite(data["sr_epochs"]).all()


def test_save_mat_reads_back(tmp_path):
    arrays = {"recon": np.arange(12, dtype=np.float32).reshape(3, 4),
              "stack": np.ones((2, 3, 4), np.float64)}
    path = str(tmp_path / "sub" / "x.mat")
    save_mat(path, arrays)
    data = sio.loadmat(path)
    assert os.path.isfile(path)
    for k, v in arrays.items():
        np.testing.assert_array_equal(data[k], v)
        assert data[k].dtype == v.dtype
