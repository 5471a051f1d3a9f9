"""Loss functions. Counterpart of ``mri_super_resolution_tpu/fit/losses.py``."""
from __future__ import annotations

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def weighted_mse(pred: torch.Tensor, target: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """Acceptance-weighted MSE (master.py:143-145): the mean of
    w (y - t)^2 over all elements, not over the weight sum."""
    return torch.mean(weights * (pred - target) ** 2)
