"""Perceptual image-quality metrics of the radiologist study, on tensors.

Counterpart of ``mri_super_resolution_tpu/ops/perceptual.py`` (``hpf_unsharp``,
``phasecong2`` :103, ``fsim`` :221, ``spectral_residue_saliency`` :286,
``sr_sim`` :311, ``ms_ssim`` :344, ``immse``, ``score_panel`` :371), the MATLAB
metrics of perceptual_similarity.m scored per panel quadrant: FSIM (gradient
and phase-congruency similarity, Kovesi's 4-scale x 4-orientation log-Gabor
bank), SR-SIM (spectral-residual saliency and Scharr gradients), multi-scale
SSIM and the unsharp high-pass filter HPF.m.

The JAX package computes these in float64 numpy and scipy on the host. Here
they are float64 tensor code (``torch.fft`` on complex128, ``F.conv2d`` for
the filters, no scipy) on the device of the tensors given: numpy arrays
become CPU tensors, so a caller that wants the card moves the images there
(``score_panel`` takes a ``device``). ``pocketfft`` and ``torch.fft`` sum in
other orders, so the two packages agree to about 1e-14, not bit for bit;
SR-SIM's spectral residual weights every FFT bin alike, so on a noiseless
image whose spectrum has bins below round-off the two FFTs' noise there can
move it by up to 1e-2 (the JAX package's own SR-SIM moves as much under a
2e-15 scaling of such an image).

The MATLAB-parity details of the JAX docstrings hold here too: conv2
'same' is a true convolution whose window starts at (k - 1) // 2 of the full
result (scipy's convention, :30-35; scipy's ``symm`` boundary, built with
flips, for 'replicate'); imfilter is a correlation whose even kernels are
centred at (k - 1) // 2, with EDGE padding for 'replicate' (:38-54); imresize
is bicubic and antialiased when it shrinks (:242-283); log|FFT| is clamped
at the smallest normal double and the spectral residual capped at 300
(:293-306); the downsampling factor uses MATLAB's round (:70). Images are
grayscale in the [0, 255] range of the MATLAB script's uint8 crops.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from mri_super_resolution_tpu_torch import resolve_device
from mri_super_resolution_tpu_torch.core.metrics import ssim as _ssim_skimage

_F64 = torch.float64
_TINY = float(np.finfo(np.float64).tiny)


def _as64(x, device=None) -> torch.Tensor:
    """``x`` (numpy or tensor) as a float64 tensor, on ``device`` when given,
    else where it lies (numpy arrays on the CPU)."""
    return torch.as_tensor(x, dtype=_F64, device=device)


def _kernel(k, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(k, dtype=_F64, device=like.device)


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------

def _symmetric_pad(x: torch.Tensor, top: int, bottom: int, left: int, right: int):
    """numpy's 'symmetric' pad (the edge sample repeated), scipy's ``symm``
    boundary; each pad at most the side it extends."""
    x = torch.cat([x[:top].flip(0), x, x[x.shape[0] - bottom:].flip(0)], dim=0)
    return torch.cat([x[:, :left].flip(1), x, x[:, x.shape[1] - right:].flip(1)], dim=1)


def _correlate_valid(padded: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    kr, kc = kernel.shape
    return F.conv2d(padded[None, None], kernel.reshape(1, 1, kr, kc))[0, 0]


def _conv2_same(img: torch.Tensor, kernel, pad_mode: str = "constant") -> torch.Tensor:
    """MATLAB conv2(..., 'same') (a true convolution, zero padding by
    default; 'replicate' is scipy's ``symm`` boundary, as the JAX package
    passes it)."""
    k = _kernel(kernel, img)
    kr, kc = k.shape
    # the 'same' window starts at (k - 1) // 2 of the full convolution
    sr, sc = (kr - 1) // 2, (kc - 1) // 2
    pads = (kr - 1 - sr, sr, kc - 1 - sc, sc)  # top, bottom, left, right
    if pad_mode == "replicate":
        padded = _symmetric_pad(img, *pads)
    elif pad_mode == "constant":
        padded = F.pad(img, (pads[2], pads[3], pads[0], pads[1]))
    else:
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    return _correlate_valid(padded, k.flip(0, 1))


def _imfilter(img: torch.Tensor, kernel, pad_mode: str = "constant") -> torch.Tensor:
    """MATLAB imfilter (correlation) with zero or replicate (EDGE) padding;
    an even kernel is centred at (k - 1) // 2, 0-based."""
    k = _kernel(kernel, img)
    kr, kc = k.shape
    top, left = (kr - 1) // 2, (kc - 1) // 2
    pad = (left, kc - 1 - left, top, kr - 1 - top)
    if pad_mode == "replicate":
        padded = F.pad(img[None, None], pad, mode="replicate")[0, 0]
    elif pad_mode == "constant":
        padded = F.pad(img, pad)
    else:
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    return _correlate_valid(padded, k)


def hpf_unsharp(img, alpha: float = 0.2) -> torch.Tensor:
    """HPF.m: imfilter with fspecial('unsharp') (a high-boost Laplacian)."""
    a = alpha
    H = (1.0 / (a + 1.0)) * np.asarray(
        [[-a, a - 1.0, -a], [a - 1.0, a + 5.0, a - 1.0], [-a, a - 1.0, -a]])
    return _imfilter(_as64(img), H)


def _avg_kernel(F_: int) -> np.ndarray:
    return np.ones((F_, F_)) / (F_ * F_)


def _matlab_round(x: float) -> int:
    """MATLAB round(): half away from zero (Python's round() is half to even:
    640 / 256 = 2.5 gives MATLAB 3 and Python 2)."""
    return int(math.floor(x + 0.5)) if x >= 0 else -int(math.floor(-x + 0.5))


def _downsample_pair(y1: torch.Tensor, y2: torch.Tensor):
    """FSIM/SR-SIM preprocessing: average filter and stride-F subsampling
    with F = max(1, round(min(rows, cols) / 256))."""
    rows, cols = y1.shape
    F_ = max(1, _matlab_round(min(rows, cols) / 256))
    if F_ > 1:
        k = _avg_kernel(F_)
        y1 = _conv2_same(y1, k)[::F_, ::F_]
        y2 = _conv2_same(y2, k)[::F_, ::F_]
    return y1, y2


_SCHARR_DX = np.asarray([[3, 0, -3], [10, 0, -10], [3, 0, -3]]) / 16.0
_SCHARR_DY = _SCHARR_DX.T


def _gradient_map(y: torch.Tensor) -> torch.Tensor:
    gx = _conv2_same(y, _SCHARR_DX)
    gy = _conv2_same(y, _SCHARR_DY)
    return torch.sqrt(gx ** 2 + gy ** 2)


def _median(x: torch.Tensor) -> torch.Tensor:
    """numpy's median: the mean of the two middle values of an even count
    (``torch.median`` returns the lower one)."""
    v = torch.sort(x.reshape(-1)).values
    n = v.numel()
    return v[n // 2] if n % 2 else (v[n // 2 - 1] + v[n // 2]) / 2


# ---------------------------------------------------------------------------
# phase congruency (Kovesi phasecong2, as embedded in FSIM.m:137-)
# ---------------------------------------------------------------------------

def _freq_axis(n: int, device) -> torch.Tensor:
    if n % 2:
        return torch.arange(-(n - 1) / 2, (n - 1) / 2 + 1, dtype=_F64, device=device) / (n - 1)
    return torch.arange(-n / 2, n / 2, dtype=_F64, device=device) / n


def phasecong2(
    im,
    nscale: int = 4,
    norient: int = 4,
    min_wavelength: float = 6.0,
    mult: float = 2.0,
    sigma_onf: float = 0.55,
    d_theta_on_sigma: float = 1.2,
    k: float = 2.0,
    epsilon: float = 1e-4,
) -> torch.Tensor:
    im = _as64(im)
    dev = im.device
    rows, cols = im.shape
    imfft = torch.fft.fft2(im)

    # frequency grids (Kovesi's convention)
    y, x = torch.meshgrid(_freq_axis(rows, dev), _freq_axis(cols, dev), indexing="ij")
    radius = torch.fft.ifftshift(torch.sqrt(x ** 2 + y ** 2))
    theta = torch.fft.ifftshift(torch.atan2(-y, x))
    radius[0, 0] = 1.0
    sintheta = torch.sin(theta)
    costheta = torch.cos(theta)

    # low-pass (raised cosine) to suppress boundary effects
    lp = torch.fft.ifftshift(1.0 / (1.0 + (torch.sqrt(x ** 2 + y ** 2) / 0.45) ** (2 * 15)))

    log_gabors = []
    for s in range(nscale):
        wavelength = min_wavelength * mult ** s
        fo = 1.0 / wavelength
        lg = torch.exp(-(torch.log(radius / fo) ** 2) / (2 * math.log(sigma_onf) ** 2))
        lg = lg * lp
        lg[0, 0] = 0.0
        log_gabors.append(lg)

    theta_sigma = math.pi / norient / d_theta_on_sigma
    total_energy = torch.zeros_like(im)
    total_sum_an = torch.zeros_like(im)
    sqrt_n = math.sqrt(rows * cols)

    for o in range(norient):
        angl = o * math.pi / norient
        ds = sintheta * math.cos(angl) - costheta * math.sin(angl)
        dc = costheta * math.cos(angl) + sintheta * math.sin(angl)
        dtheta = torch.abs(torch.atan2(ds, dc))
        spread = torch.exp(-(dtheta ** 2) / (2 * theta_sigma ** 2))

        sum_e = torch.zeros_like(im)
        sum_o = torch.zeros_like(im)
        sum_an = torch.zeros_like(im)
        eo_all, ifft_filters = [], []
        em_n = None
        for s in range(nscale):
            filt = log_gabors[s] * spread
            # MATLAB estimates the noise from the SPATIAL filters
            # real(ifft2(filter)) * sqrt(N): the orientation filters are
            # one-sided in frequency, so real() drops half their energy
            ifft_filters.append(torch.fft.ifft2(filt).real * sqrt_n)
            eo = torch.fft.ifft2(imfft * filt)
            an = torch.abs(eo)
            eo_all.append(eo)
            sum_an = sum_an + an
            sum_e = sum_e + eo.real
            sum_o = sum_o + eo.imag
            if s == 0:
                em_n = torch.sum(filt ** 2)

        x_energy = torch.sqrt(sum_e ** 2 + sum_o ** 2) + epsilon
        mean_e = sum_e / x_energy
        mean_o = sum_o / x_energy
        energy = torch.zeros_like(im)
        for eo in eo_all:
            e, o_ = eo.real, eo.imag
            energy = energy + e * mean_e + o_ * mean_o - torch.abs(e * mean_o - o_ * mean_e)

        # noise threshold from the smallest-scale amplitude (Kovesi)
        median_e2n = _median(torch.abs(eo_all[0]) ** 2)
        mean_e2n = -median_e2n / math.log(0.5)
        noise_power = mean_e2n / em_n
        est_sum_an2 = torch.zeros_like(im)
        for s in range(nscale):
            est_sum_an2 = est_sum_an2 + ifft_filters[s] ** 2
        est_sum_aiaj = torch.zeros_like(im)
        for si in range(nscale - 1):
            for sj in range(si + 1, nscale):
                est_sum_aiaj = est_sum_aiaj + ifft_filters[si] * ifft_filters[sj]
        est_noise_energy2 = (2 * noise_power * torch.sum(est_sum_an2)
                             + 4 * noise_power * torch.sum(est_sum_aiaj))
        tau = torch.sqrt(est_noise_energy2 / 2)
        est_noise_energy = tau * math.sqrt(math.pi / 2)
        est_noise_energy_sigma = torch.sqrt((2 - math.pi / 2) * tau ** 2)
        T = (est_noise_energy + k * est_noise_energy_sigma) / 1.7  # Kovesi/FSIM.m correction

        total_energy = total_energy + torch.clamp(energy - T, min=0.0)
        total_sum_an = total_sum_an + sum_an

    return total_energy / (total_sum_an + epsilon)


# ---------------------------------------------------------------------------
# FSIM / SR-SIM / MS-SSIM
# ---------------------------------------------------------------------------

def fsim(image_ref, image_dis) -> float:
    """FSIM.m main path for grayscale images (T1 = 0.85, T2 = 160)."""
    a = _as64(image_ref)
    y1, y2 = _downsample_pair(a, _as64(image_dis, a.device))
    pc1 = phasecong2(y1)
    pc2 = phasecong2(y2)
    g1 = _gradient_map(y1)
    g2 = _gradient_map(y2)
    T1, T2 = 0.85, 160.0
    pc_sim = (2 * pc1 * pc2 + T1) / (pc1 ** 2 + pc2 ** 2 + T1)
    g_sim = (2 * g1 * g2 + T2) / (g1 ** 2 + g2 ** 2 + T2)
    pcm = torch.maximum(pc1, pc2)
    return float(torch.sum(g_sim * pc_sim * pcm) / torch.sum(pcm))


def _gaussian_kernel2d(size: int, sigma: float) -> np.ndarray:
    ax = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return k / k.sum()


def _cubic_kernel(x: torch.Tensor, a: float = -0.5) -> torch.Tensor:
    """Keys bicubic (a = -0.5), support 4: MATLAB imresize's default."""
    ax = torch.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return torch.where(
        ax <= 1, (a + 2) * ax3 - (a + 3) * ax2 + 1,
        torch.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a,
                    torch.zeros_like(ax)))


def _resize_axis_matlab(arr: torch.Tensor, out_n: int, axis: int) -> torch.Tensor:
    in_n = arr.shape[axis]
    scale = out_n / in_n
    width = 4.0
    if scale < 1:  # antialiasing: stretch the kernel by 1 / scale
        kern = lambda t: scale * _cubic_kernel(scale * t)  # noqa: E731
        width /= scale
    else:
        kern = _cubic_kernel
    u = torch.arange(1, out_n + 1, dtype=_F64, device=arr.device) / scale + 0.5 * (1 - 1 / scale)
    left = torch.floor(u - width / 2)
    P = int(math.ceil(width)) + 2
    indices = left[:, None] + torch.arange(P, dtype=_F64, device=arr.device)[None, :]
    weights = kern(u[:, None] - indices)
    weights = weights / weights.sum(dim=1, keepdim=True)
    idx = torch.clamp(indices, 1, in_n).long() - 1  # replicate boundary
    moved = torch.movedim(arr, axis, 0)
    gathered = moved[idx.reshape(-1)].reshape(out_n, P, *moved.shape[1:])
    out = torch.einsum("op,op...->o...", weights, gathered)
    return torch.movedim(out, 0, axis)


def _imresize_matlab(img, scale) -> torch.Tensor:
    """MATLAB imresize: bicubic WITH antialiasing on shrink (SR_SIM.m:103
    relies on it). ``scale`` is a factor or an output shape (rows, cols)."""
    img = _as64(img)
    if isinstance(scale, tuple):
        out_shape = scale
    else:
        out_shape = (int(math.ceil(img.shape[0] * scale)), int(math.ceil(img.shape[1] * scale)))
    out = _resize_axis_matlab(img, out_shape[0], 0)
    return _resize_axis_matlab(out, out_shape[1], 1)


def spectral_residue_saliency(image) -> torch.Tensor:
    """SR_SIM.m:88-112: spectral residual saliency (Hou & Zhang)."""
    image = _as64(image)
    in_img = _imresize_matlab(image, 0.25)
    f = torch.fft.fft2(in_img)
    # log(0) = -Inf in MATLAB NaNs the map of an image with exact FFT zeros
    # (a blank slice); the clamp at the smallest normal double keeps every
    # nonzero bin's log exact and degenerate inputs finite
    log_amp = torch.log(torch.clamp(torch.abs(f), min=_TINY))
    phase = torch.angle(f)
    residual = log_amp - _imfilter(log_amp, _avg_kernel(3), pad_mode="replicate")
    # the cap keeps exp()**2 finite next to a clamped-zero neighbour; real
    # images have |residual| << 300
    sal = torch.abs(torch.fft.ifft2(torch.exp(torch.complex(torch.clamp(residual, max=300.0),
                                                             phase)))) ** 2
    sal = _imfilter(sal, _gaussian_kernel2d(10, 3.8))
    # mat2gray
    lo, hi = sal.min(), sal.max()
    rng_ = hi - lo
    sal = (sal - lo) / rng_ if float(rng_) else torch.zeros_like(sal)
    return _imresize_matlab(sal, tuple(image.shape))


def sr_sim(image1, image2) -> float:
    """SR_SIM.m main path (C1 = 0.40, C2 = 225, alpha = 0.5)."""
    a = _as64(image1)
    y1, y2 = _downsample_pair(a, _as64(image2, a.device))
    s1 = spectral_residue_saliency(y1)
    s2 = spectral_residue_saliency(y2)
    g1 = _gradient_map(y1)
    g2 = _gradient_map(y2)
    C1, C2, alpha = 0.40, 225.0, 0.5
    s_sim = (2 * s1 * s2 + C1) / (s1 ** 2 + s2 ** 2 + C1)
    g_sim = (2 * g1 * g2 + C2) / (g1 ** 2 + g2 ** 2 + C2)
    weight = torch.maximum(s1, s2)
    return float(torch.sum(s_sim * (g_sim ** alpha) * weight) / torch.sum(weight))


def _ssim_parts(a: torch.Tensor, b: torch.Tensor, data_range: float):
    """Gaussian-window (11 x 11, sigma 1.5) SSIM luminance and
    contrast-structure maps."""
    k = _gaussian_kernel2d(11, 1.5)
    mu_a = _conv2_same(a, k)
    mu_b = _conv2_same(b, k)
    va = _conv2_same(a * a, k) - mu_a ** 2
    vb = _conv2_same(b * b, k) - mu_b ** 2
    cov = _conv2_same(a * b, k) - mu_a * mu_b
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    lum = (2 * mu_a * mu_b + C1) / (mu_a ** 2 + mu_b ** 2 + C1)
    cs = (2 * cov + C2) / (va + vb + C2)
    return lum, cs


MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(a, b, data_range: float = 255.0, levels: int = 5) -> float:
    """Multi-scale SSIM (MATLAB ``multissim`` analog, standard weights)."""
    a = _as64(a)
    b = _as64(b, a.device)
    weights = np.asarray(MS_WEIGHTS[:levels])
    weights = torch.as_tensor(weights / weights.sum(), dtype=_F64, device=a.device)
    vals = []
    for lv in range(levels):
        lum, cs = _ssim_parts(a, b, data_range)
        if lv == levels - 1:
            vals.append(torch.mean(lum * cs))
        else:
            vals.append(torch.mean(cs))
            half = lambda t: (max(1, t.shape[0] // 2), max(1, t.shape[1] // 2))  # noqa: E731
            a = _imresize_matlab(_conv2_same(a, _avg_kernel(2)), half(a))
            b = _imresize_matlab(_conv2_same(b, _avg_kernel(2)), half(b))
    vals = torch.clamp(torch.stack(vals), min=1e-6)
    return float(torch.prod(vals ** weights))


def immse(a, b) -> float:
    a = _as64(a)
    return float(torch.mean((a - _as64(b, a.device)) ** 2))


# ---------------------------------------------------------------------------
# panel scoring (perceptual_similarity.m)
# ---------------------------------------------------------------------------

SCORE_KEYS = ("HF_power",) + tuple(
    f"{metric}_{hpf}{arm}"
    for metric in ("SSIM", "MSE", "MULTISSIM", "FSIM", "SR_SIM")
    for hpf in ("", "HPF_")
    for arm in ("interp", "SR"))


def score_panel(HR, interp, SR, device: str | torch.device = "cuda") -> dict:
    """Score one blinded panel's quadrants as perceptual_similarity.m:41-57
    does: every metric on (interp vs HR, SR vs HR), raw and HPF-filtered,
    and the high-frequency power gain of SR over interpolation; keys in
    :data:`SCORE_KEYS` order, computed on ``device``. The SSIM keys use the
    port's float32 ``core.metrics.ssim``, as the JAX package uses its
    float32 one; every other key is float64."""
    dev = resolve_device(device)
    HR, interp, SR = (_as64(t, dev) for t in (HR, interp, SR))
    h_hr, h_in, h_sr = hpf_unsharp(HR), hpf_unsharp(interp), hpf_unsharp(SR)
    pow_inter = torch.sum(h_in ** 2)
    power_diff = torch.sum(torch.clamp(h_sr - h_in, min=0) ** 2)

    def _ssim(x, y, L):
        return float(_ssim_skimage(x.float(), y.float(), data_range=L))

    # MATLAB quirk kept: ssim/multissim take the dynamic range from the
    # array CLASS, so uint8 panels run at L = 255 but HPF.m's single output
    # at L = 1 (perceptual_similarity.m:50-54)
    scores = {
        "HF_power": float(power_diff / pow_inter),
        "SSIM_interp": _ssim(interp, HR, 255.0),
        "SSIM_SR": _ssim(SR, HR, 255.0),
        "SSIM_HPF_interp": _ssim(h_in, h_hr, 1.0),
        "SSIM_HPF_SR": _ssim(h_sr, h_hr, 1.0),
        "MSE_interp": immse(interp, HR),
        "MSE_SR": immse(SR, HR),
        "MSE_HPF_interp": immse(h_in, h_hr),
        "MSE_HPF_SR": immse(h_sr, h_hr),
        "MULTISSIM_interp": ms_ssim(interp, HR),
        "MULTISSIM_SR": ms_ssim(SR, HR),
        "MULTISSIM_HPF_interp": ms_ssim(h_in, h_hr, data_range=1.0),
        "MULTISSIM_HPF_SR": ms_ssim(h_sr, h_hr, data_range=1.0),
        "FSIM_interp": fsim(interp, HR),
        "FSIM_SR": fsim(SR, HR),
        "FSIM_HPF_interp": fsim(h_in, h_hr),
        "FSIM_HPF_SR": fsim(h_sr, h_hr),
        "SR_SIM_interp": sr_sim(interp, HR),
        "SR_SIM_SR": sr_sim(SR, HR),
        "SR_SIM_HPF_interp": sr_sim(h_in, h_hr),
        "SR_SIM_HPF_SR": sr_sim(h_sr, h_hr),
    }
    return {k: scores[k] for k in SCORE_KEYS}
