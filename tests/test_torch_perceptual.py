"""The port's perceptual metrics (``ops/perceptual.py``) against the JAX
package's numpy ones on the same seeded images: every public function and
the filters and resize beneath them, on even and odd sides, raw and
HPF-filtered; ``score_panel``'s 21 keys; the frozen golden values of
``tests/test_perceptual_golden.py``; degenerate inputs.

Bars, read on the CPU before they were set: the float64 functions agree
within 4.0e-15 of the largest magnitude (arrays) and 1.9e-15 relative
(scalars): ``pocketfft`` and ``torch.fft``, scipy's and torch's filters sum
in other orders, so 1e-9 relative. The SSIM keys are float32 on both sides
(the port's and the JAX package's ``core.metrics.ssim``): 5.7e-6 at most,
so 1e-5 absolute. The FSIM golden values at the golden file's own 1e-6.

The SR-SIM golden values are held at 1e-2, not 1e-6: the saliency of the
noiseless ``base`` image hinges on one bin of its 24 x 24 spectrum, the
Nyquist corner, which lies below round-off (1.5e-13 from numpy's pocketfft,
1.1e-12 from torch's MKL FFT, in a spectrum whose largest bin is 7.5e4).
The spectral residual gives every bin unit weight, so that noise reaches
the score: the JAX package's own ``sr_sim`` moves by up to 6.7e-3 when the
base image is scaled by 1 +- 2e-15 (``test_srsim_golden_is_ill_conditioned``
pins it), and the port reads 3.7e-3, 6.4e-3 and 3.8e-3 from the three
goldens. On inputs whose spectra stand above round-off (every other test
here) the port holds 1e-9.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.core.metrics import ssim as jssim
from mri_super_resolution_tpu.ops import perceptual as jp
from mri_super_resolution_tpu_torch.ops import perceptual as tp
from test_perceptual_golden import GOLDEN, _images

torch.set_num_threads(2)

RTOL64, SSIM_ATOL = 1e-9, 1e-5
SHAPES = [(96, 96), (64, 64), (65, 63), (33, 40)]


def _pair(shape, seed=0):
    """A smooth image in [0, 255] and a noisy copy (tests/test_perceptual.py's
    images at any size)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:shape[0], 0:shape[1]] / 96.0
    clean = 128 + 90 * np.sin(8 * x) * np.cos(5 * y) + 20 * x
    return clean, clean + 15 * rng.normal(size=clean.shape)


def _close_array(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float64
    assert np.abs(got - want).max() <= RTOL64 * np.abs(want).max()


@pytest.mark.parametrize("hpf", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_functions_match_jax(shape, hpf):
    a, b = _pair(shape)
    if hpf:
        a, b = jp.hpf_unsharp(a), jp.hpf_unsharp(b)
    for name in ("hpf_unsharp", "phasecong2", "spectral_residue_saliency"):
        _close_array(getattr(tp, name)(a), getattr(jp, name)(a))
    for scale in (0.25, (shape[0] // 2, shape[1] // 2), (shape[0] * 2 - 1, 31)):
        _close_array(tp._imresize_matlab(a, scale), jp._imresize_matlab(a, scale))
    dr = 1.0 if hpf else 255.0
    for name, kw in (("fsim", {}), ("sr_sim", {}), ("immse", {}),
                     ("ms_ssim", {"data_range": dr})):
        want = getattr(jp, name)(a, b, **kw)
        got = getattr(tp, name)(torch.as_tensor(a), torch.as_tensor(b), **kw)
        assert isinstance(got, float)
        assert got == pytest.approx(want, rel=RTOL64, abs=0), name


@pytest.mark.parametrize("k", [2, 3, 4, 10, 11])
@pytest.mark.parametrize("pad_mode", ["constant", "replicate"])
def test_filters_match_jax(k, pad_mode):
    """conv2 'same' (a true convolution; scipy's centre for even kernels and
    its ``symm`` boundary for 'replicate') and imfilter (a correlation,
    EDGE padding for 'replicate')."""
    img, _ = _pair((23, 30))
    kernel = np.random.default_rng(k).random((k, k))
    t = torch.as_tensor(img)
    _close_array(tp._conv2_same(t, kernel, pad_mode), jp._conv2_same(img, kernel, pad_mode))
    _close_array(tp._imfilter(t, kernel, pad_mode), jp._imfilter(img, kernel, pad_mode))


def test_matlab_round():
    assert [tp._matlab_round(v) for v in (640 / 256, 384 / 256, 0.49, -2.5)] == [3, 2, 0, -3]


@pytest.mark.parametrize("shape", [(128, 128), (64, 64)])
def test_score_panel_matches_jax(shape):
    hr, noisy = _pair(shape, seed=3)
    interp = jp._conv2_same(hr, jp._gaussian_kernel2d(5, 1.2))
    sr = 0.7 * noisy + 0.3 * hr
    want = jp.score_panel(HR=hr, interp=interp, SR=sr)
    got = tp.score_panel(HR=hr, interp=torch.as_tensor(interp), SR=sr, device="cpu")
    assert list(got) == list(want) == list(tp.SCORE_KEYS) and len(got) == 21
    for key in got:
        if key.startswith("SSIM"):
            assert abs(got[key] - float(want[key])) <= SSIM_ATOL, key
        else:
            assert got[key] == pytest.approx(float(want[key]), rel=RTOL64, abs=0), key
    assert got["HF_power"] > 0


def test_hpf_ssim_uses_class_range():
    """The HPF'd SSIM keys run at L = 1 (MATLAB's single class range)."""
    hr, noisy = _pair((48, 48))
    scores = tp.score_panel(HR=hr, interp=noisy, SR=noisy, device="cpu")
    h_hr, h_sr = (np.asarray(jp.hpf_unsharp(v), np.float32) for v in (hr, noisy))
    at_1 = float(jssim(jnp.asarray(h_sr), jnp.asarray(h_hr), data_range=1.0))
    assert scores["SSIM_HPF_SR"] == pytest.approx(at_1, abs=SSIM_ATOL)


SRSIM_GOLDEN_ATOL = 1e-2


@pytest.mark.parametrize("name,fsim_gold,srsim_gold", GOLDEN)
def test_golden_values(name, fsim_gold, srsim_gold):
    imgs = _images()
    assert tp.fsim(imgs["base"], imgs[name]) == pytest.approx(fsim_gold, abs=1e-6)
    assert tp.sr_sim(imgs["base"], imgs[name]) == pytest.approx(srsim_gold,
                                                                abs=SRSIM_GOLDEN_ATOL)


def test_srsim_golden_is_ill_conditioned():
    """The JAX package's own SR-SIM of the golden pair moves by more than
    1e-3 when the base image is scaled by 1 +- 2e-15: the golden value is
    fixed to that precision only by numpy's FFT round-off."""
    imgs = _images()
    _, _, gold = GOLDEN[0]
    moved = [abs(jp.sr_sim(imgs["base"] * (1 + d), imgs["noisy"]) - gold)
             for d in (1e-15, 2e-15, -1e-15)]
    assert 1e-3 < max(moved) < SRSIM_GOLDEN_ATOL


def test_phasecong2_of_the_golden_image():
    base = _images()["base"]
    _close_array(tp.phasecong2(base), jp.phasecong2(base))


def test_degenerate_inputs_stay_finite():
    """A constant slice has exact FFT zeros off DC: the log|F| clamp and
    the residual cap keep the saliency and the scores finite; the saliency,
    FSIM and MS-SSIM equal the JAX package's."""
    flat = np.full((64, 64), 0.5)
    other = np.full((64, 64), 0.7) + 0.01 * np.eye(64)
    sal = tp.spectral_residue_saliency(flat)
    assert bool(torch.isfinite(sal).all())
    _close_array(sal, jp.spectral_residue_saliency(flat))
    assert np.isfinite(tp.sr_sim(flat, other))  # other's spectrum is round-off off its diagonal
    for name in ("fsim", "ms_ssim"):
        got = getattr(tp, name)(flat, other)
        assert got == pytest.approx(getattr(jp, name)(flat, other), rel=RTOL64), name


def test_score_panel_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tp.score_panel(np.ones((8, 8)), np.ones((8, 8)), np.ones((8, 8)))
