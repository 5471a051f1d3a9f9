"""The port's soft-ERD pipeline (INR_ERD.py) against the JAX package's:
``SirenERD`` with converted params, ``fit_until`` from injected initial
params (a normal run, and a forced collapse whose restart params are the
JAX key sequence's), one phase-2 step against ``_phase2_fn``, then
``run_case`` and ``cli/inr_erd.py`` on the CPU.

The port's phase 1 runs the plain K1 with max |out|, the JAX package's (off
the TPU) autodiff of the same loss: float32 in another order, so the loss
trace agrees to rtol 1e-5 and the params to atol 1e-5; the stopping
threshold is placed where the trace drops by a margin far above that, so
both stop at the same step.
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
from mri_super_resolution_tpu.fit.engine import fit_until as j_fit_until
from mri_super_resolution_tpu.fit.engine import plain_apply_init as j_plain_apply_init
from mri_super_resolution_tpu.models import SirenERD as JSirenERD
from mri_super_resolution_tpu.pipelines import inr_erd as jie
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.cli import inr_erd as erd_cli
from mri_super_resolution_tpu_torch.config import INRERDConfig
from mri_super_resolution_tpu_torch.core.coords import mgrid
from mri_super_resolution_tpu_torch.data import CNR_SNR_HEADER, MetricsCSV
from mri_super_resolution_tpu_torch.fit.engine import fit_until, plain_apply_init
from mri_super_resolution_tpu_torch.fit.optim import Adam
from mri_super_resolution_tpu_torch.models import SirenERD
from mri_super_resolution_tpu_torch.ops import siren_kernel as tk
from mri_super_resolution_tpu_torch.pipelines import inr_erd

torch.set_num_threads(2)

SIDE = 9
LR = 3e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def problem():
    jmodel = JSirenERD(hidden_features=16, hidden_layers=1, perturb=True)
    yy, xx = np.mgrid[0:SIDE, 0:SIDE] / (SIDE - 1)
    target = (0.3 + 0.5 * np.exp(-((xx - 0.4) ** 2 + (yy - 0.6) ** 2) / 0.1))
    return dict(jmodel=jmodel, coords=np.array(jmgrid((SIDE, SIDE))),
                target=target.reshape(-1, 1).astype(np.float32))


def _port_model(params) -> SirenERD:
    m = SirenERD(2, 16, 1, perturb="perturb" in params["params"])
    m.load_state_dict(convert.siren_erd_state_dict(_np(params)))
    return m


@pytest.mark.parametrize("perturb", [True, False])
def test_siren_erd_forward_matches_flax(problem, perturb):
    jmodel = JSirenERD(hidden_features=16, hidden_layers=1, perturb=perturb)
    coords = jnp.asarray(problem["coords"])
    params = jmodel.init(jax.random.key(4), coords, 0.0, 0.0)
    model = _port_model(params)
    assert len(model.perturb_params()) == (4 if perturb else 0)
    for sample, eps in ((0.0, 0.0), (2.0, 0.1), (5.0, 1.0)):
        want = np.asarray(jmodel.apply(params, coords, sample, eps))
        with torch.no_grad():
            got = model(torch.as_tensor(problem["coords"]), sample, eps).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


def _keys(seed, n):
    """fit_until's key sequence: the init key, then one per loop step."""
    key, sub = jax.random.split(jax.random.key(seed))
    subs = [sub]
    for _ in range(n):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return jax.random.key(seed), subs


def _port_init(model, param_trees):
    def init_fn(k):
        model.load_state_dict(convert.siren_erd_state_dict(_np(param_trees[k])))
        return model.weights()
    return init_fn


def _jax_trace(jmodel, params, coords, target, steps):
    """The loss of every step of fit_until's body, by a plain Python loop."""
    apply_fn, _ = j_plain_apply_init(jmodel)
    tx = optax.adam(LR)
    state = tx.init(params)
    vg = jax.jit(jax.value_and_grad(lambda p: jnp.mean((apply_fn(p, coords) - target) ** 2)))
    losses = []
    for _ in range(steps):
        loss, g = vg(params)
        upd, state = tx.update(g, state)
        params = optax.apply_updates(params, upd)
        losses.append(float(loss))
    return np.asarray(losses)


@pytest.mark.parametrize("route", ["kernel", "autograd"])
def test_fit_until_matches_jax(problem, route):
    """K1-absmax's plain version, or autograd through the plain trunk (the
    route without the hook), against the JAX fit_until's autodiff."""
    jmodel = problem["jmodel"]
    coords, target = jnp.asarray(problem["coords"]), jnp.asarray(problem["target"])
    key, subs = _keys(7, 0)
    p0 = jmodel.init(subs[0], jnp.zeros((1, 2)), 0.0, 0.0)
    trace = _jax_trace(jmodel, p0, coords, target, 80)
    # the first step after 20 that sets a new minimum by 1%: stop there
    k = next(i for i in range(20, 80) if trace[i] < 0.99 * trace[:i].min())
    thr = float(trace[k]) * 1.001
    apply_fn, init_fn = j_plain_apply_init(jmodel)
    jp, jsteps, jloss = j_fit_until(apply_fn, optax.adam(LR), init_fn, key, coords, target,
                                    loss_threshold=thr, max_steps=500)
    model = _port_model(p0)
    apply_plain, _ = plain_apply_init(model)
    tk.reset_launches()
    res = fit_until(apply_plain, LR, _port_init(model, [p0]),
                    torch.as_tensor(problem["coords"]), torch.as_tensor(problem["target"]),
                    loss_threshold=thr, max_steps=500,
                    value_grad_absmax_fn=(tk.make_fused_value_grad_absmax(model)
                                          if route == "kernel" else None))
    assert res.steps == int(jsteps) == k + 1 and res.restarts == []
    np.testing.assert_allclose(res.losses, trace[:k + 1], rtol=1e-5)
    np.testing.assert_allclose(res.loss, float(jloss), rtol=1e-5)
    for a, b in zip(res.params, _port_model(jp).weights()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-5)
    assert not any(tk.LAUNCHES.values())


def test_fit_until_restarts_at_the_same_step(problem):
    """A first init whose last bias is -10 collapses the ReLU output to 0:
    its step changes nothing, max |out| is 0, and both fits restart from
    the params of the next key, then run to the same end."""
    jmodel = problem["jmodel"]
    coords, target = jnp.asarray(problem["coords"]), jnp.asarray(problem["target"])
    key, subs = _keys(3, 1)
    first = jax.random.key_data(subs[0])

    def init_collapse(k):
        p = jmodel.init(k, jnp.zeros((1, 2)), 0.0, 0.0)
        inner = p["params"]
        is_first = jnp.all(jax.random.key_data(k) == first)
        bias = jnp.where(is_first, -10.0, inner["Dense_1"]["bias"])
        return {"params": {**inner, "Dense_1": {**inner["Dense_1"], "bias": bias}}}

    apply_fn, _ = j_plain_apply_init(jmodel)
    p_after = jmodel.init(subs[1], jnp.zeros((1, 2)), 0.0, 0.0)
    trace = _jax_trace(jmodel, p_after, coords, target, 60)
    k = next(i for i in range(10, 60) if trace[i] < 0.99 * trace[:i].min())
    thr = float(trace[k]) * 1.001
    jp, jsteps, jloss = j_fit_until(apply_fn, optax.adam(LR), init_collapse, key, coords,
                                    target, loss_threshold=thr, max_steps=500)
    model = _port_model(p_after)
    res = fit_until(None, LR, _port_init(model, [init_collapse(subs[0]), p_after]),
                    torch.as_tensor(problem["coords"]), torch.as_tensor(problem["target"]),
                    loss_threshold=thr, max_steps=500,
                    value_grad_absmax_fn=tk.make_fused_value_grad_absmax(model))
    assert res.restarts == [1]
    assert res.steps == int(jsteps) == k + 2  # the collapsed step, then the fit
    np.testing.assert_allclose(res.losses[1:], trace[:k + 1], rtol=1e-5)
    np.testing.assert_allclose(res.loss, float(jloss), rtol=1e-5)
    for a, b in zip(res.params, _port_model(jp).weights()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-5)


def test_plain_apply_init_draws_fresh_params():
    model = SirenERD(2, 16, 1, perturb=True)
    apply_fn, init_fn = plain_apply_init(model, torch.Generator().manual_seed(0))
    a = [w.detach().clone() for w in init_fn(0)]
    p_a = [q.detach().clone() for q in model.perturb_params()]
    b = init_fn(1)
    assert all(not torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(p_a[0], model.perturb_params()[0])  # the branch too
    x = mgrid((4, 5))
    with torch.no_grad():
        torch.testing.assert_close(apply_fn(b, x), model(x, 3.0, 0.0))


def test_phase2_step_matches_jax(problem):
    jmodel = problem["jmodel"]
    coords = jnp.asarray(problem["coords"])
    params = jmodel.init(jax.random.key(9), coords, 0.0, 0.0)
    rng = np.random.default_rng(2)
    A, P = 4, SIDE * SIDE
    targets = rng.uniform(0, 1, size=(A, P, 1)).astype(np.float32)
    weights = rng.uniform(0, 2, size=(A, P, 1)).astype(np.float32)
    eps, plr, nlr = 0.1, 1e-3, 1e-4
    tx, step = jie._phase2_fn(jmodel, eps, plr, nlr)
    state = tx.init(params)
    model = _port_model(params)
    opt_p, opt_n = Adam(model.perturb_params(), plr), Adam(model.weights(), nlr)
    ids = np.arange(A, dtype=np.float32)
    for _ in range(2):
        params, state, jloss = step(params, state, coords, jnp.asarray(ids),
                                    jnp.asarray(targets), jnp.asarray(weights))
        loss = inr_erd.phase2_step(model, opt_p, opt_n, torch.as_tensor(problem["coords"]),
                                   torch.as_tensor(ids), torch.as_tensor(targets),
                                   torch.as_tensor(weights), eps)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = convert.siren_erd_state_dict(_np(params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-6, err_msg=k)
    recon_j = np.asarray(jie._recon_mean_fn(jmodel, eps)(params, coords, jnp.asarray(ids)))
    recon_t = inr_erd.recon_mean(model, torch.as_tensor(problem["coords"]),
                                 torch.as_tensor(ids), eps)
    np.testing.assert_allclose(recon_t.numpy(), recon_j, atol=1e-5)


def _tiny_case(rng):
    """tests/test_inr_erd.py's tiny case: 24 x 24 x 3, five acquisitions."""
    H = W = 24
    S, A = 3, 5
    b0 = rng.uniform(0.8, 1.6, size=(H, W, S)).astype(np.float32)
    b3 = np.stack([b0 * 0.5 + 0.02 * rng.normal(size=(H, W, S)).astype(np.float32)
                   for _ in range(A)], axis=-1).astype(np.float32)
    return inr_erd.ERDCase(pt_id="18-1681-77", b=(0.0, 150.0, 1000.0, 1500.0),
                           cancer_loc=(12, 12), contralateral_loc=(8, 8), noise=(18, 18),
                           cancer_slice=1, b0=b0, b3=b3)


def test_run_case_on_cpu(tmp_path):
    case = _tiny_case(np.random.default_rng(0))
    cfg = INRERDConfig(hidden_features=16, hidden_layers=1, loss_threshold=2e-3, seeds=1)
    csv = MetricsCSV(str(tmp_path / "erd.csv"), CNR_SNR_HEADER)
    res = inr_erd.run_case(case, cfg, seed=0, models_dir=str(tmp_path), csv=csv,
                           device="cpu")
    assert res.mean_recon.shape == (24, 24) and np.isfinite(res.mean_recon).all()
    assert 0 < res.pretrain_steps < inr_erd.PRETRAIN_MAX_STEPS
    lines = open(csv.path).read().splitlines()
    assert len(lines) == 1 + 4 and lines[1].split(",")[-2:] == ["DWI", "orig"]
    for name in ("18-1681-77.pt", "18-1681-77_0.pt"):
        sd = torch.load(tmp_path / name)
        assert set(sd) == set(res.params)
    # phase 2 moved the perturbation branch away from the phase-1 checkpoint
    before = torch.load(tmp_path / "18-1681-77.pt")
    assert not torch.equal(before["perturb.fc0.weight"], res.params["perturb.fc0.weight"])


def test_inr_erd_cli_on_cpu(tmp_path):
    """cli/inr_erd.py on one registry patient, acquisitions synthesised from
    a (100, 100, 12) mean-b0 volume (the registry's noise ROI fits)."""
    rng = np.random.default_rng(1)
    data = tmp_path / "data"
    data.mkdir()
    yy, xx = np.mgrid[0:100, 0:100] / 99.0
    blob = 40 + 200 * np.exp(-((xx - 0.6) ** 2 + (yy - 0.7) ** 2) / 0.05)
    vol = (blob[..., None] * np.ones(12) + rng.uniform(0, 5, (100, 100, 12))).astype(np.float32)
    sio.savemat(data / "pat07_mean_b0.mat", {"data_mean_b0": vol})
    cases = erd_cli.build_cases(limit=1, num_acq=3, data_dir=str(data))
    assert cases[0].b3.shape == (100, 100, 12, 3) and float(cases[0].b0.max()) <= 1.0
    path = erd_cli.main([
        "--seeds", "1", "--limit_cases", "1", "--num_acq", "3", "--loss_threshold", "1e-2",
        "--hidden_features", "16", "--hidden_layers", "1", "--out_csv",
        str(tmp_path / "out.csv"), "--models_dir", str(tmp_path / "models"), "--data_dir",
        str(data), "--device", "cpu"])
    lines = open(path).read().splitlines()
    assert lines[0] == ",".join(CNR_SNR_HEADER) and len(lines) == 5
    assert sorted(os.listdir(tmp_path / "models")) == ["18-1681-07.pt", "18-1681-07_0.pt"]
