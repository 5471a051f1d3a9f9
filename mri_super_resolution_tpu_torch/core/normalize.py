"""Normalisation. Counterpart of ``mri_super_resolution_tpu/core/normalize.py``
(``max_normalize`` :41)."""
from __future__ import annotations

import torch


def max_normalize(img: torch.Tensor) -> torch.Tensor:
    """Divide by the global max over the last two (image) axes; leading axes
    are a batch of images (used on SSIM inputs, superresDWI.py:181-184)."""
    return img / img.amax(dim=(-2, -1), keepdim=True)
