"""The port's ERD operators and the soft-ERD study's metrics against the JAX
package's: ``auto_erd`` (every mode and linkage, on quantised intensities so
that ties occur), ``soft_erd_mean`` and ``soft_erd_weights`` (the overflow
one-hot included), ``rayleigh_noise_std``, ``minmax_normalize``,
``contrast_cnr`` and ``cnr_snr_log10``, and the 2-D fitting datasets
(``ImageFittingSet``, ``flatten_weights``). Masks must be equal; float
results agree to rtol 1e-6 (float32 reductions in other orders)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.core import metrics as jmetrics
from mri_super_resolution_tpu.core.normalize import rayleigh_noise_std as j_rayleigh
from mri_super_resolution_tpu.data import datasets as jdatasets
from mri_super_resolution_tpu.ops import erd as jerd
from mri_super_resolution_tpu_torch.core import metrics as tmetrics
from mri_super_resolution_tpu_torch.core.normalize import rayleigh_noise_std
from mri_super_resolution_tpu_torch.data import datasets as tdatasets
from mri_super_resolution_tpu_torch.ops import erd as terd

torch.set_num_threads(2)


def _stack(seed, shape=(7, 6, 9), levels=6):
    """Intensities on a grid of ``levels`` values (ties in every pixel), with
    a dark outlier acquisition here and there."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(0.2, 1.0, size=shape) * levels) / levels
    x[rng.uniform(size=shape) < 0.1] = 0.05
    return x.astype(np.float32)


@pytest.mark.parametrize("linkage", ["complete", "ward"])
@pytest.mark.parametrize("mode", [1, 2, 3])
@pytest.mark.parametrize("shape,levels", [((7, 6, 9), 6), ((5, 4, 27), 12), ((3, 3, 4), 2)])
def test_auto_erd_masks_equal(mode, linkage, shape, levels):
    img = _stack(mode * 10 + shape[-1], shape, levels)
    erd_map = np.random.default_rng(1).uniform(-1, 1, size=shape[:2]).astype(np.float32)
    want = np.asarray(jerd.auto_erd(jnp.asarray(img), jnp.asarray(erd_map) if mode == 2
                                    else None, mode=mode, linkage=linkage))
    got = terd.auto_erd(torch.as_tensor(img), torch.as_tensor(erd_map) if mode == 2
                        else None, mode=mode, linkage=linkage)
    assert got.dtype == torch.int32 and got.shape == img.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_auto_erd_refuses_unknown_options():
    img = torch.as_tensor(_stack(0))
    with pytest.raises(ValueError):
        terd.auto_erd(img, mode=2)  # no erd_map
    with pytest.raises(ValueError):
        terd.auto_erd(img, mode=4)
    with pytest.raises(ValueError):
        terd.auto_erd(img, linkage="single")


def _soft_inputs(seed):
    """(H, W, A) acquisitions, b0 and a noise level: some pixels below twice
    the noise, some where x / T exceeds 80 (T floored at 2 by a dim b0)."""
    rng = np.random.default_rng(seed)
    acq = rng.uniform(0.0, 1.0, size=(6, 5, 9)).astype(np.float32)
    b0 = rng.uniform(0.8, 1.2, size=(6, 5)).astype(np.float32)
    acq[0, :, :] = rng.uniform(170, 400, size=(5, 9))  # overflow row
    b0[0, :] = 1.0
    acq[1, 0, :] = 0.01  # below twice the noise
    acq[2, 2, :] = np.round(acq[2, 2, :] * 2) / 2  # ties
    return acq, b0, np.float32(0.05)


@pytest.mark.parametrize("seed", [0, 1])
def test_soft_erd_mean_and_weights_match(seed):
    acq, b0, noise = _soft_inputs(seed)
    for fn_j, fn_t in ((jerd.soft_erd_mean, terd.soft_erd_mean),
                       (jerd.soft_erd_weights, terd.soft_erd_weights)):
        want = np.asarray(fn_j(jnp.asarray(acq), jnp.asarray(b0), noise))
        got = fn_t(torch.as_tensor(acq), torch.as_tensor(b0), torch.tensor(noise)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    w = terd.soft_erd_weights(torch.as_tensor(acq), torch.as_tensor(b0), noise)
    assert bool((w[0].sum(-1) == 1).all()) and bool((w[0].amax(-1) == 1).all())  # one-hot
    np.testing.assert_allclose(w[1, 0].numpy(), 1.0 / 9)


def test_noise_and_metrics_match():
    rng = np.random.default_rng(3)
    roi = rng.rayleigh(0.1, size=(5, 5, 9)).astype(np.float32)
    np.testing.assert_allclose(float(rayleigh_noise_std(torch.as_tensor(roi))),
                               float(j_rayleigh(jnp.asarray(roi))), rtol=1e-6)
    img = rng.uniform(0.1, 2.0, size=(30, 30)).astype(np.float32)
    ref = rng.uniform(0.0, 5.0, size=(30, 30)).astype(np.float32)
    np.testing.assert_allclose(
        tmetrics.minmax_normalize(torch.as_tensor(img), torch.as_tensor(ref)).numpy(),
        np.asarray(jmetrics.minmax_normalize(jnp.asarray(img), jnp.asarray(ref))),
        rtol=1e-6, atol=1e-6)
    # locations inside, and near or past the edges (the windows clamp)
    for locs, focus, scale in ((((15, 16), (10, 12), (25, 5)), 0, 1),
                               (((48, 50), (41, 42), (69, 66)), 40, 2),
                               (((0, 29), (29, 1), (1, 1)), 0, 1)):
        want = jmetrics.contrast_cnr(jnp.asarray(img), *locs, scale=scale, focus=focus)
        got = tmetrics.contrast_cnr(torch.as_tensor(img), *locs, scale=scale, focus=focus)
        np.testing.assert_allclose([float(v) for v in got], [float(v) for v in want],
                                   rtol=1e-6)
    for locs in (((15, 16), (10, 12), (25, 5)), ((0, 29), (29, 1), (1, 1))):
        want = jmetrics.cnr_snr_log10(jnp.asarray(img), *locs)
        got = tmetrics.cnr_snr_log10(torch.as_tensor(img), *locs)
        assert got._fields == want._fields
        np.testing.assert_allclose([float(v) for v in got], [float(v) for v in want],
                                   rtol=1e-6)


@pytest.mark.parametrize("normalize", [False, True])
def test_image_fitting_set_matches(normalize):
    rng = np.random.default_rng(4)
    images = [rng.uniform(0, 1, size=(5, 7)).astype(np.float32) for _ in range(3)]
    want = jdatasets.ImageFittingSet.from_images(images, normalize=normalize)
    got = tdatasets.ImageFittingSet.from_images(images, normalize=normalize)
    assert len(got) == len(want) == 3 and got.shape == want.shape == (5, 7)
    for name in ("pixels", "coords", "mean") + (("orig",) if normalize else ()):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=1e-6, atol=1e-7)
    assert got.orig is None if not normalize else got.orig.shape == (3, 5, 7)
    np.testing.assert_array_equal(got.coords_for_all().numpy(),
                                  np.asarray(want.coords_for_all()))
    w = [(rng.uniform(size=(5, 7)) > 0.5).astype(np.float32) for _ in range(3)]
    np.testing.assert_array_equal(tdatasets.flatten_weights(w).numpy(),
                                  np.asarray(jdatasets.flatten_weights(w)))
