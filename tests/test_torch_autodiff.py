"""The port's INR differential operators (``core/autodiff.py``) against the
JAX package's on analytic fields and on a small SIREN converted from flax,
with and without a Fourier encoding in front.

Bars, read on the CPU before they were set: the analytic fields to float32
rounding (rtol 1e-5, as the JAX tests); on the SIREN the gradient, Laplacian and
divergence within 1.6e-6 of the largest magnitude of the JAX operators'
(float32 products in other orders, the Fourier encoding's 2 pi x B^T
among them), so 1e-5 of the largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.core import autodiff as jad
from mri_super_resolution_tpu.core.coords import fourier_encode as j_fourier_encode
from mri_super_resolution_tpu.models import Siren as JSiren
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.core import autodiff as tad
from mri_super_resolution_tpu_torch.core.coords import fourier_encode
from mri_super_resolution_tpu_torch.models import Siren

torch.set_num_threads(2)


def _coords(n=10, d=2):
    return np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)


def quadratic(x):  # grad (2x, 6y), Laplacian 8
    return (x[..., 0] ** 2 + 3.0 * x[..., 1] ** 2)[..., None]


def vector_field(x):  # divergence 7
    return torch.stack([2.0 * x[..., 0], 5.0 * x[..., 1]], dim=-1)


def test_analytic_fields():
    c = _coords()
    t = torch.as_tensor(c)
    np.testing.assert_allclose(tad.gradient(quadratic, t).numpy(),
                               np.stack([2 * c[:, 0], 6 * c[:, 1]], -1), rtol=1e-5)
    np.testing.assert_allclose(tad.divergence(vector_field, t).numpy(), 7.0, rtol=1e-6)
    np.testing.assert_allclose(tad.laplace(quadratic, t).numpy(), 8.0, rtol=1e-5)
    # sin(x) cos(2y): Laplacian -5 sin(x) cos(2y)
    wave = lambda x: torch.sin(x[..., :1]) * torch.cos(2 * x[..., 1:])  # noqa: E731
    want = -5 * np.sin(c[:, 0]) * np.cos(2 * c[:, 1])
    np.testing.assert_allclose(tad.laplace(wave, t).numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mapping", [0, 4])
def test_siren_matches_jax(mapping):
    c = _coords(17, 3)
    B = None if not mapping else (
        np.random.default_rng(1).normal(size=(mapping, 3)).astype(np.float32) * 0.5)
    jB = None if B is None else jnp.asarray(B)
    in_f = 3 if B is None else 2 * mapping
    jmodel = JSiren(hidden_features=16, hidden_layers=1)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, in_f)))
    model = Siren(in_f, 16, 1)
    model.load_state_dict(convert.siren_state_dict(jax.tree.map(np.asarray, params)))
    model.requires_grad_(False)
    tB = None if B is None else torch.as_tensor(B)

    jf = lambda x: jmodel.apply(params, j_fourier_encode(x, jB))  # noqa: E731
    tf = lambda x: model(fourier_encode(x, tB))  # noqa: E731
    jc, tc = jnp.asarray(c), torch.as_tensor(c)
    # a vector field: the SIREN's gradient itself
    jv = lambda x: jad.gradient(jf, x)  # noqa: E731
    tv = lambda x: tad.gradient(tf, x)  # noqa: E731
    for got, want in ((tad.gradient(tf, tc), jad.gradient(jf, jc)),
                      (tad.laplace(tf, tc), jad.laplace(jf, jc)),
                      (tad.divergence(tv, tc), jad.divergence(jv, jc))):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
