"""PIDS: physics-induced defect and suspect voxels of a hybrid slice.

Counterpart of ``mri_super_resolution_tpu/ops/pids.py``
(``detect_pids_slice`` :29, ``pids_weight_map`` :55), itself the
vectorised ``detect_PIDS_slice`` of the reference (PIA.py:286-327):

- PIDS_ADC1: polyfit ADC over b at TE index 0 above 3 (signal lost at high
  b to motion);
- PIDS_ADC2: that ADC below 0 (the voxel under the noise floor);
- PIDS_TE_decay: the signal not falling between consecutive TEs, per b;
- PIDS_b_decay: the signal not falling between consecutive b-values, per TE.

As the reference, the monotonicity rules truncate the earlier sample to an
integer before differencing (``astype(int)``, PIA.py:305/313).
"""
from __future__ import annotations

import torch

from mri_super_resolution_tpu_torch.core.adc import adc_polyfit


def _decay_flags(x: torch.Tensor) -> torch.Tensor:
    """x (..., 4): flag i is x[i + 1] - trunc(x[i]) >= 0, i in 0..2."""
    return (x[..., 1:4] - torch.trunc(x[..., :3]) >= 0).to(torch.float32)


def detect_pids_slice(b, S: torch.Tensor):
    """``b`` (4,) b-values, ``S`` (H, W, B, T) hybrid slice. Returns
    (PIDS_ADC1 (H, W), PIDS_ADC2 (H, W), PIDS_b_decay (H, W, T, 3),
    PIDS_TE_decay (H, W, B, 3)) as float 0/1 maps."""
    adc = adc_polyfit(b, S[..., 0], min_adc=-float("inf"), max_adc=float("inf"))
    pids_adc1 = (adc > 3.0).to(torch.float32)
    pids_adc2 = (adc < 0.0).to(torch.float32)
    pids_te = _decay_flags(S)
    pids_b = _decay_flags(S.transpose(-1, -2))
    return pids_adc1, pids_adc2, pids_b, pids_te


def pids_weight_map(b, S: torch.Tensor, clean_weight: float = 1.0,
                    defect_weight: float = 0.0) -> torch.Tensor:
    """Per-voxel loss weight (the PIDS mask of PIA.loss_function,
    PIA.py:150-153): ``defect_weight`` where either ADC rule fires."""
    a1, a2, _, _ = detect_pids_slice(b, S)
    return torch.where((a1 + a2) > 0, defect_weight, clean_weight).to(torch.float32)
