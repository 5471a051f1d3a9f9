"""The port's coordinates, normalisation, interpolation, SSIM and ADC against
the JAX package's, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.core import adc as jadc
from mri_super_resolution_tpu.core import coords as jcoords
from mri_super_resolution_tpu.core import interp as jinterp
from mri_super_resolution_tpu.core import metrics as jmetrics
from mri_super_resolution_tpu.core import normalize as jnorm
from mri_super_resolution_tpu_torch.core import adc as tadc
from mri_super_resolution_tpu_torch.core import coords as tcoords
from mri_super_resolution_tpu_torch.core import interp as tinterp
from mri_super_resolution_tpu_torch.core import metrics as tmetrics
from mri_super_resolution_tpu_torch.core import normalize as tnorm

torch.set_num_threads(2)


@pytest.mark.parametrize("shape", [(5, 4, 3, 4), (7, 1, 2), (3,)])
def test_mgrid_exact(shape):
    np.testing.assert_array_equal(tcoords.mgrid(shape).numpy(),
                                  np.asarray(jcoords.mgrid(shape)))


def test_fourier_encode():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=(300, 4)).astype(np.float32)
    B = (rng.normal(size=(16, 4)) * 0.5).astype(np.float32)
    ref = np.asarray(jcoords.fourier_encode(jnp.asarray(x), jnp.asarray(B)))
    got = tcoords.fourier_encode(torch.as_tensor(x), torch.as_tensor(B)).numpy()
    assert got.shape == (300, 32)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    xt = torch.as_tensor(x)
    assert tcoords.fourier_encode(xt, None) is xt


def test_fourier_matrix_seeded():
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = tcoords.fourier_matrix(g1, 128, 4, scale=0.5)
    b = tcoords.fourier_matrix(g2, 128, 4, scale=0.5)
    assert a.shape == (128, 4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert 0.4 < float(a.std()) < 0.6  # N(0, 1) * scale


def test_max_normalize():
    x = np.random.default_rng(1).uniform(0, 3, size=(6, 5)).astype(np.float32)
    np.testing.assert_allclose(tnorm.max_normalize(torch.as_tensor(x)).numpy(),
                               np.asarray(jnorm.max_normalize(jnp.asarray(x))),
                               atol=1e-7)


@pytest.mark.parametrize("shape,scale", [((8, 8), 2), ((13, 9), 2), ((7, 6), 4)])
def test_rescale_matches_jax_linear(shape, scale):
    img = np.random.default_rng(2).uniform(0, 1, size=shape).astype(np.float32)
    ref = np.asarray(jinterp.rescale(jnp.asarray(img), scale, anti_aliasing=True))
    got = tinterp.rescale(torch.as_tensor(img), scale, anti_aliasing=True).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_rescale_refuses_downscale():
    with pytest.raises(ValueError):
        tinterp.rescale(torch.zeros(4, 4), 0.5)


def test_ssim_and_masked_protocol():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, size=(3, 20, 18)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, size=a.shape), 0, None).astype(np.float32)
    got_s = tmetrics.ssim(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    got_m = tmetrics.masked_ssim_protocol(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    for i in range(3):
        ja, jb = jnp.asarray(a[i]), jnp.asarray(b[i])
        np.testing.assert_allclose(got_s[i], float(jmetrics.ssim(ja, jb)), atol=1e-5)
        np.testing.assert_allclose(got_m[i], float(jmetrics.masked_ssim_protocol(ja, jb)),
                                   atol=1e-5)


def test_adc_polyfit():
    rng = np.random.default_rng(4)
    sig = rng.uniform(0.05, 1.0, size=(10, 9, 4)).astype(np.float32)
    bv = np.asarray([0.0, 150.0, 1000.0, 1500.0])
    ref = np.asarray(jadc.adc_polyfit(jnp.asarray(bv), jnp.asarray(sig)))
    got = tadc.adc_polyfit(bv, torch.as_tensor(sig)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert got.max() <= 3.0 and got.min() >= -10.0
