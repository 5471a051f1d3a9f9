"""The port's batched fits against the JAX package's vmapped ones: the
stacked Adam (``fit/optim.StackedAdam``) against D separate ``Adam``s,
``fit_ensemble_batched`` and ``fit_simple_batched`` against ``jax.vmap`` of
the JAX loops, and the two pipelines that run them (the 2-D ensemble's
``fit_directions``, the hybrid fit's ``"siren"`` arm) from converted JAX
inits.

The stacked Adam is held to D separate ``Adam``s bit for bit on the CPU,
with a masked slot and with restarts: elementwise it does the same float32
operations in the same order. The fits run the plain batched K1 where the
JAX package takes autodiff on the CPU: float32 in another order, so the loss
traces agree to rtol 1e-5 and predictions and params to atol 1e-5 over these
few steps (``tests/test_torch_master2d.py``'s and
``tests/test_torch_hybrid.py``'s tolerances).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mri_super_resolution_tpu.config import Master2DConfig as JConfig
from mri_super_resolution_tpu.core.coords import fourier_encode as jfourier_encode
from mri_super_resolution_tpu.core.coords import fourier_matrix as jfourier_matrix
from mri_super_resolution_tpu.core.coords import mgrid as jmgrid
from mri_super_resolution_tpu.fit import engine as jengine
from mri_super_resolution_tpu.fit import optim as joptim
from mri_super_resolution_tpu.models import Siren as JSiren
from mri_super_resolution_tpu.pipelines import hybrid as jhy
from mri_super_resolution_tpu.pipelines import master2d as jm2d
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.config import Master2DConfig
from mri_super_resolution_tpu_torch.core.coords import mgrid
from mri_super_resolution_tpu_torch.data import synthetic
from mri_super_resolution_tpu_torch.fit.engine import fit_ensemble_batched, fit_simple_batched
from mri_super_resolution_tpu_torch.fit.optim import Adam, StackedAdam, flat_view
from mri_super_resolution_tpu_torch.ops import siren_kernel as tk
from mri_super_resolution_tpu_torch.pipelines import hybrid as thy
from mri_super_resolution_tpu_torch.pipelines import master2d

torch.set_num_threads(2)

TRACE_RTOL, ATOL = 1e-5, 1e-5
SHAPES = [(16, 2), (16,), (16, 16), (16,), (1, 16), (1,)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _draws(rng, D, shapes):
    return [torch.as_tensor(rng.normal(size=(D, *s)).astype(np.float32)) for s in shapes]


@pytest.mark.parametrize("restart_every", [0, 3])
def test_stacked_adam_matches_separate_adams_bit_for_bit(restart_every):
    """Three slots over 12 steps: slot 1 masked every third step, slot 2
    from step 5 on; each slot against its own Adam, which takes only the
    slot's real steps (so its restart schedule counts those alone, as the
    JAX package's masked restart state does)."""
    rng = np.random.default_rng(0)
    D = 3
    init = _draws(rng, D, SHAPES)
    ref = [Adam([p[s].clone() for p in init], 1e-3, restart_every) for s in range(D)]
    opt = StackedAdam(init, 1e-3, restart_every)
    for step in range(12):
        g = _draws(rng, D, SHAPES)
        ok = np.array([True, step % 3 != 1, step < 5])
        for s in range(D):
            if ok[s]:
                ref[s].step([t[s] for t in g])
        opt.step(g, ok)
        for s in range(D):
            assert opt.count[s] == ref[s].count
            for a, b in zip(opt.params, ref[s].params):
                assert torch.equal(a[s], b), (step, s)
    assert opt.count.tolist() == [ref[s].count for s in range(D)]
    flat_mu = torch.cat([m.reshape(-1) for m in ref[1].mu])
    assert torch.equal(opt.mu[1], flat_mu)


def test_stacked_adam_takes_any_grad_layout():
    """The same update from grads that are views of one buffer in the
    params' order (the batched K1's), from separate tensors, and from their
    flat (D, n) form; a step with every slot masked changes nothing."""
    rng = np.random.default_rng(1)
    init = _draws(rng, 2, SHAPES)
    opts = [StackedAdam(init, 1e-3) for _ in range(3)]
    buf = torch.as_tensor(rng.normal(size=(2, 16 * 3 + 16 * 17 + 17 + 2)).astype(np.float32))
    views = [buf.as_strided(*v) for v in tk._param_views((2, 16, 16, 1), 2, buf.stride(0))]
    assert flat_view(views) is not None and flat_view([v.clone() for v in views[::-1]]) is None
    opts[0].step(views)
    opts[1].step([v.clone() for v in views])
    opts[2].step(flat_view(views))
    for a, b, c in zip(*(o.params for o in opts)):
        assert torch.equal(a, b) and torch.equal(a, c)
    before = opts[0].flat.clone()
    opts[0].step(views, [False, False])
    assert torch.equal(opts[0].flat, before) and opts[0].count.tolist() == [1, 1]


def _jax_stack(hidden, layers, D, seed, x):
    model = JSiren(hidden_features=hidden, hidden_layers=layers, out_features=1)
    keys = jax.random.split(jax.random.key(seed), D)
    return model, jax.vmap(lambda k: model.init(k, x[:4]))(keys)


def test_fit_ensemble_batched_matches_vmapped_jax():
    """Three directions of 3, 1 and 2 acquisitions padded to 3 slots: the
    JAX package's ``vmap`` of ``fit_ensemble`` against the port's batched
    fit from the same init; loss traces, predictions and final params."""
    rng = np.random.default_rng(2)
    H, W, D, A, steps, seg = 7, 6, 3, 3, 5, 2
    counts = (3, 1, 2)
    pix = np.zeros((D, A, H * W, 1), np.float32)
    w = np.zeros((D, A, H * W, 1), np.float32)
    valid = np.zeros((D, A), bool)
    for d, n in enumerate(counts):
        pix[d, :n] = rng.uniform(-1, 1, size=(n, H * W, 1))
        w[d, :n] = rng.uniform(size=(n, H * W, 1)) > 0.2
        valid[d, :n] = True
    coords, coords_s = jmgrid((H, W)), jmgrid((2 * H, 2 * W))
    model, stack = _jax_stack(16, 1, D, 4, coords)
    init = convert.siren_batched_weights(_np(stack))  # before JAX donates the params
    tx = optax.adam(1e-4)

    def one(params, p, ww, ok):
        return jengine.fit_ensemble(model.apply, tx, params, coords, p, ww, coords, coords_s,
                                    total_steps=steps, seg=seg, valid=ok)

    ref = jax.vmap(one)(stack, jnp.asarray(pix), jnp.asarray(w), jnp.asarray(valid))
    res = fit_ensemble_batched(
        lambda p, x: tk.siren_forward_batched_ref(x, p),
        StackedAdam(init, 1e-4), mgrid((H, W)),
        torch.as_tensor(pix), torch.as_tensor(w), mgrid((H, W)), mgrid((2 * H, 2 * W)),
        steps, seg, valid=valid,
        weighted_value_and_grad_fn=tk.make_fused_weighted_value_and_grad_batched(
            master2d.Siren(2, 16, 1)))
    assert res.losses.shape == (steps, D)
    np.testing.assert_allclose(res.losses.numpy().T, np.asarray(ref.losses), rtol=TRACE_RTOL)
    np.testing.assert_allclose(res.pred_1x.numpy(), np.asarray(ref.pred_1x), atol=ATOL)
    np.testing.assert_allclose(res.pred_scale.numpy(), np.asarray(ref.pred_scale), atol=ATOL)
    for a, b in zip(res.params, convert.siren_batched_weights(_np(ref.params))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


def test_fit_simple_batched_with_restarts_matches_vmapped_jax():
    """Four stacked FF-SIRENs (16 -> 32 -> 1) on their own targets, Adam
    restarted every 5 steps (the hybrid fit's ``inr_restart_every``): the
    JAX ``fit_simple`` under ``vmap`` against ``fit_simple_batched``."""
    rng = np.random.default_rng(3)
    P, steps = 60, 12
    x = rng.uniform(-1, 1, size=(P, 16)).astype(np.float32)
    targets = rng.uniform(0, 1, size=(4, P, 1)).astype(np.float32)
    model, stack = _jax_stack(32, 1, 4, 5, jnp.asarray(x))
    init = convert.siren_batched_weights(_np(stack))  # before JAX donates the params
    tx = joptim.restart_adam(1e-4, 5)
    ref = jax.vmap(lambda p, t: jengine.fit_simple(model.apply, tx, p, jnp.asarray(x), t,
                                                   steps))(stack, jnp.asarray(targets))
    opt = StackedAdam(init, 1e-4, restart_every=5)
    res = fit_simple_batched(opt, torch.as_tensor(x), torch.as_tensor(targets), steps,
                             tk.make_fused_value_and_grad_batched(master2d.Siren(16, 32, 1)))
    np.testing.assert_allclose(res.losses.numpy().T, np.asarray(ref.losses), rtol=TRACE_RTOL)
    for a, b in zip(res.params, convert.siren_batched_weights(_np(ref.params))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


def test_fit_directions_equal_counts_matches_jax():
    """The 2-D ensemble's common case, every direction with the same count
    (no padded slot): the JAX package's vmapped fit against the port's
    batched one from the JAX init."""
    rng = np.random.default_rng(6)
    H, W, counts = 6, 8, (2, 2, 2)
    roi = rng.uniform(0.2, 1.0, size=(H, W, sum(counts))).astype(np.float32)
    accept = (rng.uniform(size=roi.shape) > 0.25).astype(np.float32)
    kw = dict(hidden_features=16, hidden_layers=1, total_steps=4, seg=2, scale=2)
    _, stack = _jax_stack(16, 1, 3, 0, jmgrid((H, W)))
    want_1x, want_s = jm2d.fit_directions(roi, accept, counts, JConfig(**kw), 0)
    got_1x, got_s = master2d.fit_directions(roi, accept, counts, Master2DConfig(**kw), 0,
                                            device="cpu",
                                            params_stack=convert.siren_stack_weights(
                                                _np(stack)))
    np.testing.assert_allclose(got_1x, want_1x, atol=ATOL)
    np.testing.assert_allclose(got_s, want_s, atol=ATOL)


def test_fit_directions_plain_route_matches_jax():
    """``use_pallas=False`` (the CPU's autograd route through the batched
    plain forward, with unequal counts and so a padded slot) against the
    JAX package's XLA route from the same init."""
    rng = np.random.default_rng(8)
    H, W, counts = 7, 5, (2, 1, 2)
    roi = rng.uniform(0.2, 1.0, size=(H, W, sum(counts))).astype(np.float32)
    accept = (rng.uniform(size=roi.shape) > 0.25).astype(np.float32)
    kw = dict(hidden_features=16, hidden_layers=1, total_steps=4, seg=2, scale=2,
              use_pallas=False)
    _, stack = _jax_stack(16, 1, 3, 1, jmgrid((H, W)))
    want_1x, want_s = jm2d.fit_directions(roi, accept, counts, JConfig(**kw), 1)
    got_1x, got_s = master2d.fit_directions(roi, accept, counts, Master2DConfig(**kw), 1,
                                            device="cpu",
                                            params_stack=convert.siren_stack_weights(
                                                _np(stack)))
    np.testing.assert_allclose(got_1x, want_1x, atol=ATOL)
    np.testing.assert_allclose(got_s, want_s, atol=ATOL)


def test_fit_all_te_siren_arm_with_restarts_matches_jax():
    """The hybrid fit's ``"siren"`` arm (four TEs in one batched fit) with
    Adam restarts every 7 of 15 epochs, from the JAX package's B and init:
    the reconstruction and the four loss traces' ends."""
    rng = np.random.default_rng(7)
    b0 = np.abs(rng.normal(1.0, 0.2, (12, 12, 2))).astype(np.float32)
    hybrid = jhy.mean_over_acquisitions(
        synthetic.hybrid_from_b0(b0, acq_counts=(1, 2, 2, 2), seed=1))
    kw = dict(roi_start_x=2, roi_end_x=10, roi_start_y=2, roi_end_y=10, number_of_epochs=15,
              hidden_dim=32, num_layers=1, mapping_size=8, inr_restart_every=7)
    jcfg, tcfg = jhy.HybridConfig(**kw), thy.HybridConfig(**kw)
    traces, make_stack = [], jhy._make_fit_stack

    def recording(*a):  # the JAX fit program, its (4, epochs) loss traces kept
        run = make_stack(*a)

        def recorded(*b):
            fitted, losses = run(*b)
            traces.append(np.asarray(losses))
            return fitted, losses

        return recorded

    mp = pytest.MonkeyPatch()
    mp.setattr(jhy, "_make_fit_stack", recording)
    try:
        jres = jhy.fit_all_te(hybrid, jcfg, seed=0)
    finally:
        mp.undo()
    kB, kI = jax.random.split(jax.random.key(0))
    B = jfourier_matrix(kB, 8, 4, scale=jcfg.ff_scale)
    m = JSiren(hidden_features=32, hidden_layers=1)
    ff = jfourier_encode(jmgrid((4, 4, 2, 4)), B)
    inits = [convert.siren_state_dict(_np(m.init(k, ff[:8])))
             for k in jax.random.split(kI, 4)]
    tres = thy.fit_all_te(hybrid, tcfg, seed=0, device="cpu",
                          init={"B": np.array(B), "inr": inits})
    assert tres.losses.shape == traces[0].shape == (4, 15)
    assert (tres.losses[:, -1] < tres.losses[:, 0]).all()
    np.testing.assert_allclose(tres.losses, traces[0], rtol=TRACE_RTOL, atol=0)
    np.testing.assert_allclose(tres.recon_hybrid, jres.recon_hybrid, atol=ATOL)
