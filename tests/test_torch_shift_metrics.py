"""The port's shift-tolerant metrics against the JAX package's
``ops/shift_metrics.py``: ``shift_l1_loss`` and its gradient, ``shift_psnr``
(reduced and per image), ``ssim_tf`` and ``shift_ssim`` (``clear_only``
both ways), on seeded numpy inputs.

Each prediction is its label shifted by a known offset, brightened by a
bias and lightly noised, and a quarter of the mask is zero, so the best of
the 49 offsets is clear in both packages (a near-tie could pick another
argmin in either). Tolerances: float32 sums of up to 18 x 18 x 49 terms in
another order, relative 1e-5 (values) and 1e-4 (gradients).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.ops import shift_metrics as jsm
from mri_super_resolution_tpu_torch.ops import shift_metrics as tsm

torch.set_num_threads(2)

HR = 24
CROP = HR - 2 * tsm.BORDER


def _problem(B=3, C=1, seed=0):
    rng = np.random.default_rng(seed)
    y_true = rng.uniform(5000, 9000, (B, HR, HR, C)).astype(np.float32)
    y_pred = rng.uniform(5000, 9000, (B, HR, HR, C)).astype(np.float32)
    for i in range(B):
        di, dj = rng.integers(0, 2 * tsm.BORDER + 1, size=2)
        crop = y_true[i, di:di + CROP, dj:dj + CROP] + 300.0 * (i + 1)
        y_pred[i, 3:3 + CROP, 3:3 + CROP] = crop + rng.normal(0, 20, crop.shape)
    mask = np.ones_like(y_true)
    mask[:, : HR // 4] = 0.0
    return y_true, y_pred, mask


def _both(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("C", [1, 2])
def test_shift_l1_loss_and_gradient_match_jax(C):
    arrays = _problem(C=C, seed=C)
    (jt, jp, jm), (tt, tp, tmask) = _both(arrays)
    w = np.asarray([0.5, 1.0, 2.0], np.float32)
    ref = np.asarray(jsm.shift_l1_loss(jt, jp, jm, HR))
    gref = np.asarray(jax.grad(lambda p: jnp.sum(jsm.shift_l1_loss(jt, p, jm, HR) * w))(jp))
    tp.requires_grad_()
    got = tsm.shift_l1_loss(tt, tp, tmask, HR)
    (grad,) = torch.autograd.grad((got * torch.as_tensor(w)).sum(), tp)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), gref, rtol=1e-4,
                               atol=1e-4 * np.abs(gref).max())


@pytest.mark.parametrize("C", [1, 2])
def test_shift_psnr_matches_jax(C):
    (jt, jp, jm), (tt, tp, tmask) = _both(_problem(C=C, seed=10 + C))
    per = tsm.shift_psnr(tt, tp, tmask, HR, reduce=False)
    assert per.shape == (3,)
    np.testing.assert_allclose(per.numpy(), np.asarray(
        jsm.shift_psnr(jt, jp, jm, HR, reduce=False)), rtol=1e-5)
    np.testing.assert_allclose(float(tsm.shift_psnr(tt, tp, tmask, HR)),
                               float(jsm.shift_psnr(jt, jp, jm, HR)), rtol=1e-5)


def test_ssim_tf_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 65535, (2, 20, 17, 3)).astype(np.float32)
    b = (a + rng.normal(0, 3000, a.shape)).astype(np.float32)
    ref = np.asarray(jsm.ssim_tf(jnp.asarray(a), jnp.asarray(b), tsm.PEAK))
    got = tsm.ssim_tf(torch.as_tensor(a), torch.as_tensor(b), tsm.PEAK).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("clear_only", [False, True])
def test_shift_ssim_matches_jax(clear_only):
    (jt, jp, jm), (tt, tp, tmask) = _both(_problem(seed=20))
    ref = float(jsm.shift_ssim(jt, jp, jm, HR, clear_only=clear_only))
    got = float(tsm.shift_ssim(tt, tp, tmask, HR, clear_only=clear_only))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
