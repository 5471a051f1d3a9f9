"""ADC maps. Counterpart of ``mri_super_resolution_tpu/core/adc.py``
(``adc_polyfit`` :32-54)."""
from __future__ import annotations

import torch

EPS = 1e-7


def adc_polyfit(bvalues, signal: torch.Tensor, min_adc: float = -10.0,
                max_adc: float = 3.0, dim: int = -1) -> torch.Tensor:
    """Least-squares ADC over the b-value axis ``dim``, clamped to
    ``[min_adc, max_adc]``: ``-polyfit(b/1000, log(signal + eps), 1)[0]`` per
    voxel, as the closed-form regression slope cov(x, y) / var(x)."""
    x = torch.as_tensor(bvalues, dtype=torch.float32,
                        device=signal.device).reshape(-1) / 1000.0
    y = torch.log(torch.movedim(signal, dim, -1) + EPS)
    xc = x - x.mean()
    slope = (y * xc).sum(-1) / (xc * xc).sum()
    return torch.clamp(-slope, min_adc, max_adc)
