"""Spline-baseline rescale. Counterpart of
``mri_super_resolution_tpu/core/interp.py`` (``_gaussian_kernel1d``,
``_gaussian_blur2d`` and ``rescale`` :24-60)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _gaussian_kernel1d(sigma: float, radius: int) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _gaussian_blur2d(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of the last two axes, radius ``int(4 sigma +
    0.5)``, reflect padding (scipy ndimage 'mirror'); along each row (the
    last axis) first, then along each column, as the reference does."""
    radius = int(4.0 * sigma + 0.5)
    if radius < 1:
        return img
    k = _gaussian_kernel1d(sigma, radius).to(img.device, img.dtype)
    h, w = img.shape[-2:]
    x = img.reshape(-1, 1, h, w)
    x = F.conv2d(F.pad(x, (radius, radius, 0, 0), mode="reflect"), k.reshape(1, 1, 1, -1))
    x = F.conv2d(F.pad(x, (0, 0, radius, radius), mode="reflect"), k.reshape(1, 1, -1, 1))
    return x.reshape(img.shape)


def rescale(img: torch.Tensor, scale: float, anti_aliasing: bool = False) -> torch.Tensor:
    """Resize the last two axes to ``int(n * scale)`` with linear
    interpolation (``jax.image.resize(..., 'linear')``: half-pixel centres).

    Upscaling takes an integer ``scale >= 1`` (bilinear ``F.interpolate``,
    edge samples held; anti-aliasing is a no-op, as in the reference).
    Downscaling (``scale < 1``) takes ``anti_aliasing=True``, the only way
    either package calls it: a Gaussian prefilter of skimage's sigma
    ``(1 / scale - 1) / 2``, then the resize, which like ``jax.image.resize``
    spreads its triangle kernel over ``1 / scale`` input pixels and
    renormalises the weights at the edges (``antialias=True``)."""
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    if scale < 1:
        if not anti_aliasing or scale <= 0:
            raise ValueError("rescale downscales only with anti_aliasing=True and "
                             f"0 < scale < 1; got scale {scale}, anti_aliasing "
                             f"{anti_aliasing}")
        img = _gaussian_blur2d(img, (1.0 / scale - 1.0) / 2.0)
    elif int(scale) != scale:
        raise ValueError(f"rescale upscales by an integer scale >= 1; got {scale}")
    size = (int(h * scale), int(w * scale))
    out = F.interpolate(img.reshape(-1, 1, h, w), size=size, mode="bilinear",
                        align_corners=False, antialias=scale < 1)
    return out.reshape(*lead, *size)
