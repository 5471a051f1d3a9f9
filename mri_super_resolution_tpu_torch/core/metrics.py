"""SSIM protocol. Counterpart of ``mri_super_resolution_tpu/core/metrics.py``
(``ssim`` :118-149, ``masked_ssim_protocol`` :159-169). Leading axes are a
batch of 2-D images."""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def masked_ssim_protocol(hr: torch.Tensor, other: torch.Tensor,
                         mask_thresh: float = 0.05,
                         data_range: float = 1.0) -> torch.Tensor:
    """The SSIM protocol of superresDWI.py:179-187: both images max-normalised
    by the caller, ``hr > thresh`` applied multiplicatively to both."""
    mask = (hr > mask_thresh).to(hr.dtype)
    return ssim(hr * mask, other * mask, data_range=data_range)
