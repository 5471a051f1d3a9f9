"""Image-quality and contrast metrics. Counterpart of
``mri_super_resolution_tpu/core/metrics.py``: ``minmax_normalize`` (:28),
``contrast_cnr`` (:43-73), ``cnr_snr_log10`` (:84-107), ``ssim``
(:118-149), ``psnr`` (:153-157), ``masked_ssim_protocol`` (:159-169). The
SSIM functions take a leading batch of 2-D images."""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

EPS = 1e-7


def minmax_normalize(img: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Affinely map ``img`` onto the min/max range of ``ref`` (master.py:46-48)."""
    unit = (img - img.min()) / (img.max() - img.min())
    return unit * (ref.max() - ref.min()) + ref.min()


def _window(image: torch.Tensor, x: int, y: int, size: int) -> torch.Tensor:
    """``image[x:x+size, y:y+size]`` with the start placed as
    ``jax.lax.dynamic_slice`` places it: a negative start counts from the
    end, then the window is clamped into the image."""
    def start(i, n):
        i = int(i) + (n if int(i) < 0 else 0)
        return min(max(i, 0), n - size)

    x, y = start(x, image.shape[0]), start(y, image.shape[1])
    return image[x:x + size, y:y + size]


def _std(t: torch.Tensor) -> torch.Tensor:
    return torch.std(t, correction=0)


class ContrastMetrics(NamedTuple):
    C: torch.Tensor
    CNR: torch.Tensor
    CNR2: torch.Tensor


def contrast_cnr(image: torch.Tensor, cancer_loc, contralateral_loc, noise_loc,
                 scale: int = 1, focus: int = 0) -> ContrastMetrics:
    """Cancer-vs-contralateral contrast metrics (nn_mri.py:59-85) over
    ``2 scale`` squares at ``(loc - focus) * scale - scale``. CNR2 divides
    by the noise area's std, as the reference does."""

    def roi(loc):
        x, y = ((c - focus) * scale for c in loc)
        return _window(image, x - scale, y - scale, 2 * scale)

    ca, co, no = roi(cancer_loc), roi(contralateral_loc), roi(noise_loc)
    cm, bm = ca.mean(), co.mean()
    varc, varb = _std(ca) ** 2, _std(co) ** 2
    C = cm / (bm + EPS)
    CNR = torch.abs(cm - bm) / torch.sqrt(varc + varb)
    CNR2 = torch.abs(cm - bm) / _std(no)
    return ContrastMetrics(C, CNR, CNR2)


class CNRSNRMetrics(NamedTuple):
    log10_SNRc: torch.Tensor
    log10_CNR: torch.Tensor
    Sc: torch.Tensor
    Sb: torch.Tensor
    CR: torch.Tensor


def cnr_snr_log10(image: torch.Tensor, cancer_loc, contralateral_loc,
                  noise_loc) -> CNRSNRMetrics:
    """log10 SNR/CNR metrics of the soft-ERD study (INR_ERD.py:102-124): 3x3
    ROIs on cancer and contralateral, 5x5 on noise."""
    (cx, cy), (bx, by), (nx, ny) = cancer_loc, contralateral_loc, noise_loc
    ca = _window(image, cx - 1, cy - 1, 3)
    co = _window(image, bx - 1, by - 1, 3)
    no = _window(image, nx - 2, ny - 2, 5)
    Sc, Sb, N = ca.mean(), co.mean(), _std(no)
    SNRc = Sc / (N + EPS)
    SNRb = Sb / (N + EPS)
    return CNRSNRMetrics(torch.log10(SNRc), torch.log10(torch.abs(SNRc - SNRb)), Sc, Sb,
                         Sc / Sb)


def _uniform_filter(x: torch.Tensor, win: int) -> torch.Tensor:
    """Valid-mode mean filter over the last two axes: a 1-D mean along the
    rows axis, then along the columns axis, as the reference does."""
    h, w = x.shape[-2:]
    y = x.reshape(-1, 1, h, w)
    k = torch.full((1, 1, win, 1), 1.0 / win, dtype=x.dtype, device=x.device)
    y = F.conv2d(y, k)
    y = F.conv2d(y, k.reshape(1, 1, 1, win))
    return y.reshape(*x.shape[:-2], h - win + 1, w - win + 1)


def ssim(im1: torch.Tensor, im2: torch.Tensor, data_range: float = 1.0,
         win_size: int = 7) -> torch.Tensor:
    """Structural similarity with skimage's defaults: ``win_size`` uniform
    window, sample covariance (NP/(NP-1)), K1=0.01, K2=0.03, mean over the
    valid map. Returns one value per image."""
    im1 = im1.float()
    im2 = im2.float()
    NP = win_size * win_size
    cov_norm = NP / (NP - 1.0)
    ux = _uniform_filter(im1, win_size)
    uy = _uniform_filter(im2, win_size)
    uxx = _uniform_filter(im1 * im1, win_size)
    uyy = _uniform_filter(im2 * im2, win_size)
    uxy = _uniform_filter(im1 * im2, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
    B1, B2 = ux ** 2 + uy ** 2 + C1, vx + vy + C2
    S = (A1 * A2) / (B1 * B2)
    return S.mean(dim=(-2, -1))


def psnr(im1: torch.Tensor, im2: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio (skimage ``peak_signal_noise_ratio``) over
    the whole of both tensors, in float32."""
    mse = torch.mean((im1.float() - im2.float()) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / mse)


def masked_ssim_protocol(hr: torch.Tensor, other: torch.Tensor,
                         mask_thresh: float = 0.05,
                         data_range: float = 1.0) -> torch.Tensor:
    """The SSIM protocol of superresDWI.py:179-187: both images max-normalised
    by the caller, ``hr > thresh`` applied multiplicatively to both."""
    mask = (hr > mask_thresh).to(hr.dtype)
    return ssim(hr * mask, other * mask, data_range=data_range)
