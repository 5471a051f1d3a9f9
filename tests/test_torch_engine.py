"""The port's fit engine against the JAX package's: Adam (flat and with
restarts), fit_simple, fit_alternating_pn and infer_dense_grid, from the same
converted initial parameters and Fourier matrix.

Fits are chaotic over long horizons (the JAX package's fit/optim.py notes
>10 dB spreads between identical 2500-step reruns), so only short runs are
compared, step by step, at rtol 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mri_super_resolution_tpu.core.coords import fourier_encode as jff
from mri_super_resolution_tpu.core.coords import mgrid as jmgrid
from mri_super_resolution_tpu.fit import engine as jeng
from mri_super_resolution_tpu.fit.optim import restart_adam as jrestart
from mri_super_resolution_tpu.models import PerturbNet as JPerturbNet
from mri_super_resolution_tpu.models import Siren as JSiren
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.core.coords import mgrid
from mri_super_resolution_tpu_torch.fit import engine as teng
from mri_super_resolution_tpu_torch.fit.optim import Adam, restart_adam
from mri_super_resolution_tpu_torch.models import perturbnet_apply
from mri_super_resolution_tpu_torch.ops.siren_kernel import (
    siren_forward_ref,
    siren_fused,
    siren_loss_grads,
)

torch.set_num_threads(2)

SHAPE = (6, 5, 3, 4)  # LR grid: 360 rows


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    B = (rng.normal(size=(8, 4)) * 0.5).astype(np.float32)
    coords = np.asarray(jmgrid(SHAPE))
    ff = np.array(jff(jnp.asarray(coords), jnp.asarray(B)))
    P = coords.shape[0]
    target = rng.uniform(0, 1, size=(P, 1)).astype(np.float32)
    acq = rng.uniform(0, 1, size=(3, P, 1)).astype(np.float32)
    inr = JSiren(hidden_features=48, hidden_layers=2)
    inr_params = inr.init(jax.random.key(1), jnp.asarray(ff[:8]))
    pn = JPerturbNet(hidden_features=16, dimension=4)
    pn_params = pn.init(jax.random.key(2), jnp.asarray(ff[:8]), 0, 0.0)
    return dict(B=B, ff=ff, target=target, acq=acq, inr=inr, inr_params=inr_params,
                pn=pn, pn_params=pn_params)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _siren_weights(params):
    return [w.clone() for w in convert.siren_weights(_np(params))]


def _pn_weights(params):
    return [w.clone() for w in convert.perturbnet_state_dict(_np(params)).values()]


def _kernel_apply(params, x):
    return siren_fused(x, params)


def _kernel_vag(params, x, target):
    return siren_loss_grads(x, params, target)


def _plain_apply(params, x):
    return siren_forward_ref(x, params)


@pytest.mark.parametrize("every", [0, 3])
def test_adam_matches_optax(every):
    """Adam == optax.adam; with restarts, moments and count reset every N."""
    rng = np.random.default_rng(3)
    p0 = [rng.normal(size=(5, 4)).astype(np.float32), rng.normal(size=(4,)).astype(np.float32)]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in p0] for _ in range(8)]
    tx = jrestart(1e-2, every)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.as_tensor(p.copy()) for p in p0]
    opt = restart_adam(tp, 1e-2, every) if every else Adam(tp, 1e-2)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.as_tensor(x) for x in g])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


def test_restart_differs_from_flat():
    g = [torch.ones(3)]
    a, b = [torch.zeros(3)], [torch.zeros(3)]
    oa, ob = Adam(a, 0.1), restart_adam(b, 0.1, 2)
    for k in range(4):
        oa.step([g[0] * (k + 1)])
        ob.step([g[0] * (k + 1)])
    assert not torch.allclose(a[0], b[0])


@pytest.mark.parametrize("route", ["autograd", "kernel"])
def test_fit_simple_losses(problem, route):
    ref = jeng.fit_simple(problem["inr"].apply, optax.adam(1e-4),
                          jax.tree.map(jnp.copy, problem["inr_params"]),
                          jnp.asarray(problem["ff"]), jnp.asarray(problem["target"]), 8)
    params = _siren_weights(problem["inr_params"])
    res = teng.fit_simple(
        _plain_apply, Adam(params, 1e-4), torch.as_tensor(problem["ff"]),
        torch.as_tensor(problem["target"]), 8,
        value_and_grad_fn=_kernel_vag if route == "kernel" else None)
    np.testing.assert_allclose(res.losses.numpy(), np.asarray(ref.losses), rtol=1e-3)
    final = convert.siren_weights(_np(ref.params))
    for a, b in zip(res.params, final):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_fit_alternating_pn_losses(problem):
    """8 epochs, the last 4 alternating (absolute epochs 4..7: even = one PN
    step per combination through the INR's input, odd = one INR step), with
    the double Fourier mapping; PN Adam state carried across combinations."""
    ff, B = jnp.asarray(problem["ff"]), jnp.asarray(problem["B"])
    ref = jeng.fit_alternating_pn(
        problem["inr"].apply, problem["pn"].apply, optax.adam(1e-4), optax.adam(1e-6),
        jax.tree.map(jnp.copy, problem["inr_params"]),
        jax.tree.map(jnp.copy, problem["pn_params"]), ff,
        jnp.asarray(problem["target"]), jnp.asarray(problem["acq"]), B,
        num_epochs=8, pn_epochs=4)
    inr_w, pn_w = _siren_weights(problem["inr_params"]), _pn_weights(problem["pn_params"])
    res = teng.fit_alternating_pn(
        _kernel_apply, perturbnet_apply, Adam(inr_w, 1e-4), Adam(pn_w, 1e-6),
        torch.as_tensor(problem["ff"]), torch.as_tensor(problem["target"]),
        torch.as_tensor(problem["acq"]), torch.as_tensor(problem["B"]),
        num_epochs=8, pn_epochs=4, inr_value_and_grad=_kernel_vag)
    np.testing.assert_allclose(res.losses.numpy(), np.asarray(ref.losses), rtol=1e-3)
    ref_pn = list(convert.perturbnet_state_dict(_np(ref.pn_params)).values())
    for a, b in zip(res.pn_params, ref_pn):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    # the PN really moved: its gradient reached it through the INR's input
    for a, b in zip(res.pn_params, _pn_weights(problem["pn_params"])):
        assert not torch.equal(a, b)


def test_phase2_start_parity(problem):
    """phase2_start fixes the absolute parity: starting at the odd epoch 3
    makes the one alternating step an INR step, so the PN does not move."""
    inr_w, pn_w = _siren_weights(problem["inr_params"]), _pn_weights(problem["pn_params"])
    pn_before = [w.clone() for w in pn_w]
    teng.fit_alternating_pn(
        _plain_apply, perturbnet_apply, Adam(inr_w, 1e-4), Adam(pn_w, 1e-6),
        torch.as_tensor(problem["ff"]), torch.as_tensor(problem["target"]),
        torch.as_tensor(problem["acq"]), torch.as_tensor(problem["B"]),
        num_epochs=1, pn_epochs=1, phase2_start=3)
    for a, b in zip(pn_w, pn_before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,chunk", [((7, 6, 3, 4), 100), ((5, 1, 2, 4), 16)])
def test_infer_dense_grid_matches_jax(problem, shape, chunk):
    B = problem["B"]
    ref = jeng.infer_dense_grid(problem["inr"].apply, problem["inr_params"], shape,
                                chunk=chunk, clamp_min=0.0, fourier_B=jnp.asarray(B))
    got = teng.infer_dense_grid(_kernel_apply, _siren_weights(problem["inr_params"]),
                                shape, chunk=chunk, clamp_min=0.0,
                                fourier_B=torch.as_tensor(B))
    assert got.shape == ref.shape == (int(np.prod(shape)), 1)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert (got >= 0).all()


def test_infer_dense_grid_equals_mgrid_inference(problem):
    params = _siren_weights(problem["inr_params"])
    B = torch.as_tensor(problem["B"])
    dense = teng.infer_dense_grid(_plain_apply, params, SHAPE, chunk=50, fourier_B=B)
    grid = teng.infer_grid(_plain_apply, params, mgrid(SHAPE), chunk=50, fourier_B=B)
    np.testing.assert_allclose(dense, grid.numpy(), atol=1e-5)
    with pytest.raises(ValueError):
        teng.infer_dense_grid(_plain_apply, params, (2 ** 16, 2 ** 15, 1, 1),
                              fourier_B=B)


def test_autodiff_and_kernel_value_and_grad_agree(problem):
    params = _siren_weights(problem["inr_params"])
    x, t = torch.as_tensor(problem["ff"]), torch.as_tensor(problem["target"])
    la, ga = teng.autodiff_value_and_grad(_plain_apply, params, x, t)
    lk, gk = _kernel_vag(params, x, t)
    torch.testing.assert_close(la, lk, rtol=1e-5, atol=0)
    for a, b in zip(ga, gk):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
