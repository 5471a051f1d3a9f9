"""Shift-tolerant L1 / cPSNR / cSSIM for multi-image super-resolution.

Counterpart of ``mri_super_resolution_tpu/ops/shift_metrics.py``
(reference: multi-image-super-resolution/utils/loss.py:26-177). The
prediction is cropped by a 3-px border; the ground truth (and its quality
mask) slides over all (2 * 3 + 1)^2 = 49 integer offsets; each offset gets a
per-image brightness-bias correction ``b = mean(GT - pred)`` over masked
pixels; the loss takes the minimum over offsets (the metrics the maximum).
PSNR peak is 65535 (uint16 data). Images are ``(B, H, W, C)``.

The 49 crops are stacked into one ``(49, B, crop, crop, C)`` tensor and
scored in one batched computation. :func:`shift_l1_loss` searches the
offsets under ``torch.no_grad`` and recomputes the loss, with its gradient,
at each image's best offset: the backward touches ``(B, crop, crop, C)``
tensors, not 49 times that, and gives the same values and gradients.

``ssim_tf`` is ``tf.image.ssim`` (11 x 11 Gaussian window, sigma 1.5, k1
0.01, k2 0.03, valid padding), as loss.py:160 uses it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BORDER = 3
PEAK = 65535.0
SHIFTS = 2 * BORDER + 1


def _stack_shifts(y: torch.Tensor, crop: int) -> torch.Tensor:
    """(B, H, W, C) -> (49, B, crop, crop, C) over all border offsets."""
    return torch.stack([y[:, i:i + crop, j:j + crop]
                        for i in range(SHIFTS) for j in range(SHIFTS)])


def _corrected(pred_crop, label, mask):
    """Masked brightness-corrected prediction + masked label
    (loss.py:49-66); sums over the two image axes (-3, -2)."""
    mask = mask.float()
    pred_m = pred_crop.float() * mask
    label_m = label.float() * mask
    total = mask.sum((-3, -2), keepdim=True)
    b = (label_m - pred_m).sum((-3, -2), keepdim=True) / total
    corrected = (pred_m + b) * mask
    return corrected, label_m, total


def _l1(pred_crop, label, mask) -> torch.Tensor:
    """Masked brightness-corrected L1 per image, meaned over channels."""
    corrected, label_m, total = _corrected(pred_crop, label, mask)
    l1 = (label_m - corrected).abs().sum((-3, -2)) / total[..., 0, 0]
    return l1.mean(-1)


def _crop(y_pred: torch.Tensor, hr_size: int) -> torch.Tensor:
    return y_pred[:, BORDER:hr_size - BORDER, BORDER:hr_size - BORDER]


def shift_l1_loss(y_true: torch.Tensor, y_pred: torch.Tensor, y_mask: torch.Tensor,
                  hr_size: int = 96) -> torch.Tensor:
    """Min-over-shifts masked brightness-corrected L1 (loss.py:26-75):
    inputs (B, hr_size, hr_size, C), the per-image loss (B,)."""
    crop = hr_size - 2 * BORDER
    pred_crop = _crop(y_pred, hr_size)
    labels = _stack_shifts(y_true.detach(), crop)
    masks = _stack_shifts(y_mask, crop)
    with torch.no_grad():
        best = _l1(pred_crop.detach(), labels, masks).argmin(0)  # (B,)
    rows = torch.arange(y_true.shape[0], device=y_true.device)
    return _l1(pred_crop, labels[best, rows], masks[best, rows])


def shift_psnr(y_true: torch.Tensor, y_pred: torch.Tensor, y_mask: torch.Tensor,
               hr_size: int = 96, reduce: bool = True) -> torch.Tensor:
    """Max-over-shifts cPSNR (loss.py:77-127): the batch mean, or with
    ``reduce=False`` the per-image ``(B,)`` values."""
    crop = hr_size - 2 * BORDER
    corrected, label_m, total = _corrected(_crop(y_pred, hr_size),
                                           _stack_shifts(y_true, crop),
                                           _stack_shifts(y_mask, crop))
    mse = ((label_m - corrected) ** 2).sum((-3, -2)) / total[..., 0, 0]
    best = (10.0 * torch.log10(PEAK ** 2 / mse)).mean(-1).amax(0)
    return best.mean() if reduce else best


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim_tf(a: torch.Tensor, b: torch.Tensor, max_val: float, size: int = 11,
            sigma: float = 1.5) -> torch.Tensor:
    """``tf.image.ssim``: Gaussian-windowed SSIM, valid padding, averaged
    over space and channels. Inputs (B, H, W, C); returns (B,)."""
    C = a.shape[-1]
    win = _gaussian_window(size, sigma).to(a.device).expand(C, 1, size, size)

    def filt(x):  # depthwise valid convolution, channels-last in and out
        return F.conv2d(x.permute(0, 3, 1, 2), win, groups=C).permute(0, 2, 3, 1)

    a, b = a.float(), b.float()
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_a, mu_b = filt(a), filt(b)
    va = filt(a * a) - mu_a ** 2
    vb = filt(b * b) - mu_b ** 2
    cov = filt(a * b) - mu_a * mu_b
    lum = (2 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)
    cs = (2 * cov + c2) / (va + vb + c2)
    return (lum * cs).mean((1, 2, 3))


def shift_ssim(y_true: torch.Tensor, y_pred: torch.Tensor, y_mask: torch.Tensor,
               hr_size: int = 96, clear_only: bool = False) -> torch.Tensor:
    """Max-over-shifts cSSIM, meaned over the batch (loss.py:131-177)."""
    crop = hr_size - 2 * BORDER
    corrected, label_m, total = _corrected(_crop(y_pred, hr_size),
                                           _stack_shifts(y_true, crop),
                                           _stack_shifts(y_mask, crop))
    n, B = corrected.shape[:2]
    s = ssim_tf(corrected.flatten(0, 1), label_m.flatten(0, 1), PEAK).reshape(n, B)
    if clear_only:
        s = (s - 1.0) * total[..., 0, 0].mean(-1) / (crop * crop) + 1.0
    return s.amax(0).mean()

