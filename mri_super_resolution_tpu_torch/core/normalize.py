"""Normalisation. Counterpart of ``mri_super_resolution_tpu/core/normalize.py``
(``to_tensor_normalize`` :21, ``max_normalize`` :41, ``rayleigh_noise_std``
:46)."""
from __future__ import annotations

import math

import torch


def to_tensor_normalize(img):
    """torchvision's ``Normalize(mean=0.5, std=0.5)`` on an already-float
    image, ``(img - 0.5) / 0.5`` (numpy arrays and tensors alike)."""
    return (img - 0.5) / 0.5


def max_normalize(img: torch.Tensor) -> torch.Tensor:
    """Divide by the global max over the last two (image) axes; leading axes
    are a batch of images (used on SSIM inputs, superresDWI.py:181-184)."""
    return img / img.amax(dim=(-2, -1), keepdim=True)


def rayleigh_noise_std(noise_roi: torch.Tensor) -> torch.Tensor:
    """Rayleigh-corrected background noise sigma (INR_ERD.py:178-181):
    the population std of the ROI over sqrt(2 - pi / 2)."""
    return torch.std(noise_roi, correction=0) / math.sqrt(2.0 - math.pi / 2.0)
