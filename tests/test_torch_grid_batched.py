"""The hybrid fit's grid arm as one batched fit: the port's batched GridINR
tensor path (``models/grid_inr.py:grid_inr_tensor_apply_batched``,
``make_tensor_value_and_grad_batched``) against four unbatched calls, the
stacked Adam over stacked GridINR params against four ``restart_adam``s,
and ``fit_all_te(inr_model="grid")`` running the batched step once an
epoch and the in-turn ``_fit`` never, on the CPU.

The four GridINRs (2 levels, base 4, F 2, hidden 8, z_divisor 1, the
hybrid's 4 b slots) are initialised by flax from four keys, their grids
pushed to O(0.3) so that interpolation errors would show, and converted
with ``convert.grid_inr_from_flax``; the batched functions see them
stacked, the unbatched ones one at a time.

Measured gaps (the batched head's products, its weight gradients summed
in row chunks, and the slot axis in the einsums sum in other orders than
four unbatched calls): outputs 1.2e-7 of values up to 0.86, the per-slot
loss 1.3e-7 relative, the gradients 1.4e-6 of each one's largest magnitude
(8,192 rows; 6.5e-7 at 1,400). Tolerances: 1e-5 absolute on outputs, 1e-6
relative on the loss, 1e-5 of the largest magnitude on each gradient. The stacked Adam is held bit for bit: elementwise it does
Adam's float32 operations in Adam's order.
"""
import jax
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.core.coords import mgrid as jmgrid
from mri_super_resolution_tpu.models import grid_inr as jg
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.core.coords import mgrid
from mri_super_resolution_tpu_torch.data import synthetic
from mri_super_resolution_tpu_torch.fit.optim import StackedAdam, restart_adam
from mri_super_resolution_tpu_torch.models import GridINR
from mri_super_resolution_tpu_torch.models import grid_inr as tg
from mri_super_resolution_tpu_torch.pipelines import hybrid as thy

torch.set_num_threads(2)

CFG = dict(num_levels=2, base_resolution=4, features_per_level=2, hidden=8, z_divisor=1)
# (nx, ny, nz, nb): the hybrid test's LR grid, one whose axes put samples
# on knots and between them, and one of 8,192 rows, whose head's weight
# gradients sum the rows in 32 chunks of 256 (``_row_chunked_gram``)
SHAPES = [(8, 8, 2, 4), (7, 10, 5, 4), (16, 16, 8, 4)]
ATOL, LOSS_RTOL, GRAD_TOL = 1e-5, 1e-6, 1e-5
D = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """Four converted flax GridINRs, each as a port module."""
    jm = jg.GridINR(**CFG)
    rng = np.random.default_rng(1)
    out = []
    for key in jax.random.split(jax.random.key(0), D):
        p = jm.init(key, jmgrid((2, 2, 2, 4)))
        p = jax.tree.map(
            lambda a: a + np.float32(0.3) * rng.normal(size=a.shape).astype(np.float32), p)
        tm = GridINR(**CFG)
        tm.load_state_dict(convert.grid_inr_from_flax(_np(p)))
        tm.requires_grad_(False)
        out.append(tm)
    return out


def _stack(models):
    return [torch.stack(ps) for ps in zip(*(m.params() for m in models))]


@pytest.mark.parametrize("shape", SHAPES)
def test_batched_apply_matches_each_slot(models, shape):
    got = tg.grid_inr_tensor_apply_batched(_stack(models), shape)
    assert got.shape == (D, int(np.prod(shape)), 1)
    for s, m in enumerate(models):
        want = tg.grid_inr_tensor_apply(m.params(), shape)
        np.testing.assert_allclose(got[s].numpy(), want.numpy(), atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_batched_vag_matches_four_unbatched_calls(models, shape):
    """Each slot's loss and every gradient against
    ``make_tensor_value_and_grad`` called on that slot alone; ``coords`` is
    not read by either."""
    P = int(np.prod(shape))
    targets = torch.as_tensor(
        np.random.default_rng(shape[2]).uniform(0, 1, (D, P, 1)).astype(np.float32))
    loss, grads = tg.make_tensor_value_and_grad_batched(shape)(_stack(models), None, targets)
    assert loss.shape == (D,) and len(grads) == len(models[0].params())
    vag = tg.make_tensor_value_and_grad(shape)
    for s, m in enumerate(models):
        want_loss, want_grads = vag(m.params(), mgrid(shape), targets[s])
        np.testing.assert_allclose(float(loss[s]), float(want_loss), rtol=LOSS_RTOL)
        for g, w, p in zip(grads, want_grads, m.params()):
            assert g.shape == (D, *p.shape)
            np.testing.assert_allclose(g[s].numpy(), w.numpy(),
                                       atol=GRAD_TOL * float(w.abs().max()))


@pytest.mark.parametrize("rows", [512, 8192, 8200])
def test_batched_linear_matches_baddbmm_autograd(rows):
    """The batched head's layer against autograd through ``torch.baddbmm``
    in float64: the same forward bits, and gradients within 1e-12 of the
    largest (the weight gradient sums 512 rows in one product, 8,192 in 32
    chunks, and 8,200 in 32 chunks and a tail of 8 rows)."""
    rng = np.random.default_rng(rows)
    h, W, b = (torch.as_tensor(rng.normal(size=s)).requires_grad_()
               for s in ((D, rows, 24), (D, 64, 24), (D, 64)))
    g = torch.as_tensor(rng.normal(size=(D, rows, 64)))
    out = tg._BatchedLinear.apply(h, W, b)
    ref = torch.baddbmm(b[:, None], h, W.transpose(1, 2))
    assert torch.equal(out, ref)
    for got, want in zip(torch.autograd.grad(out, (h, W, b), g),
                         torch.autograd.grad(ref, (h, W, b), g)):
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=1e-12 * float(want.abs().max()))


def test_stacked_adam_over_grid_params_matches_four_restart_adams(models):
    """Ten steps of the batched tensor-path gradients, restarts every 3:
    each slot's view of the stacked Adam's buffer against its own
    ``restart_adam`` fed that slot's gradients, bit for bit; every view
    lies in the one (D, n_params) buffer with each slot's tensor contiguous
    in its row, in ``GridINR.params`` order."""
    shape = SHAPES[1]
    P = int(np.prod(shape))
    targets = torch.as_tensor(
        np.random.default_rng(2).uniform(0, 1, (D, P, 1)).astype(np.float32))
    opt = StackedAdam(_stack(models), 5e-3, restart_every=3)
    refs = [restart_adam([p.clone() for p in m.params()], 5e-3, 3) for m in models]
    at = 0
    for p, q in zip(opt.params, models[0].params()):
        assert p.shape == (D, *q.shape) and p.stride(0) == opt.flat.shape[1]
        assert p[0].is_contiguous() and p.storage_offset() == at
        assert p.untyped_storage().data_ptr() == opt.flat.untyped_storage().data_ptr()
        at += q.numel()
    vag = tg.make_tensor_value_and_grad_batched(shape)
    for step in range(10):
        _, grads = vag(opt.params, None, targets)
        opt.step(grads)
        for s, ref in enumerate(refs):
            ref.step([g[s] for g in grads])
            assert opt.count[s] == ref.count
            for a, b in zip(opt.params, ref.params):
                assert torch.equal(a[s], b), (step, s)
    assert opt.count.tolist() == [1] * D  # the restart before step 10 reset it


def test_fit_all_te_grid_arm_runs_one_batched_fit(monkeypatch):
    """``fit_all_te(inr_model="grid")``: the batched value-and-grad once an
    epoch over all four TEs, the in-turn ``_fit`` and the unbatched
    value-and-grad never."""
    rng = np.random.default_rng(3)
    b0 = np.abs(rng.normal(1.0, 0.2, (12, 12, 2))).astype(np.float32)
    hybrid = thy.mean_over_acquisitions(
        synthetic.hybrid_from_b0(b0, acq_counts=(1, 2, 2, 2), seed=0))
    calls = {"batched": 0, "unbatched": 0}
    make_batched = tg.make_tensor_value_and_grad_batched
    make_plain = tg.make_tensor_value_and_grad

    def counting_batched(shape):
        vag = make_batched(shape)

        def counted(params, coords, targets):
            assert targets.shape[0] == D and all(p.shape[0] == D for p in params)
            calls["batched"] += 1
            return vag(params, coords, targets)

        return counted

    def counting_plain(shape):
        calls["unbatched"] += 1
        return make_plain(shape)

    def no_fit(*a, **k):
        raise AssertionError("the grid arm fitted a TE in turn")

    monkeypatch.setattr(thy, "make_tensor_value_and_grad_batched", counting_batched)
    monkeypatch.setattr(thy, "make_tensor_value_and_grad", counting_plain)
    monkeypatch.setattr(thy, "_fit", no_fit)
    cfg = thy.HybridConfig(number_of_epochs=6, inr_model="grid", inr_restart_every=4,
                           roi_start_x=2, roi_end_x=10, roi_start_y=2, roi_end_y=10,
                           grid_levels=2, grid_base_resolution=4, grid_features=2,
                           grid_hidden=8)
    res = thy.fit_all_te(hybrid, cfg, seed=0, device="cpu")
    assert calls == {"batched": 6, "unbatched": 0}
    assert res.losses.shape == (D, 6) and np.isfinite(res.losses).all()
    assert res.recon_hybrid.shape == (16, 16, 2, 4, 4) and (res.recon_hybrid >= 0).all()
