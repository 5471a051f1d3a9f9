"""Loss functions. Counterpart of ``mri_super_resolution_tpu/fit/losses.py``."""
from __future__ import annotations

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)
