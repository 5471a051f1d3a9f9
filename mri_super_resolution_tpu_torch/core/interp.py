"""Spline-baseline rescale. Counterpart of
``mri_super_resolution_tpu/core/interp.py`` (``rescale`` :46-60)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rescale(img: torch.Tensor, scale: int, anti_aliasing: bool = False) -> torch.Tensor:
    """Upscale the last two axes by an integer factor ``scale >= 1`` with
    linear interpolation (``jax.image.resize(..., 'linear')``: half-pixel
    centres, edge samples held), which is bilinear ``F.interpolate`` with
    ``align_corners=False``. Anti-aliasing only filters when downscaling, so
    for ``scale >= 1`` it is a no-op, as in the reference; downscaling is not
    ported."""
    del anti_aliasing  # no-op for scale >= 1 (skimage/reference semantics)
    if int(scale) != scale or scale < 1:
        raise ValueError(f"rescale takes an integer scale >= 1; got {scale}")
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    x = img.reshape(-1, 1, h, w)
    out = F.interpolate(x, size=(h * int(scale), w * int(scale)), mode="bilinear",
                        align_corners=False)
    return out.reshape(*lead, h * int(scale), w * int(scale))
