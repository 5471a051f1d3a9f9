"""Coordinate grids and Fourier-feature encodings.

Counterpart of ``mri_super_resolution_tpu/core/coords.py`` (``mgrid``
:24-42, ``fourier_matrix`` :50-59, ``fourier_encode`` :62-75).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def mgrid(shape: Sequence[int], device: str | torch.device = "cpu",
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Flattened ``[-1, 1]^d`` grid for a tensor of ``shape``:
    ``linspace(-1, 1, n)`` per axis, ``indexing='ij'``, reshaped to
    ``(prod(shape), len(shape))``. Built in float64 with numpy and cast, as
    the reference builds it, so the two agree exactly."""
    axes = [np.linspace(-1.0, 1.0, int(n)) for n in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    out = np.stack(grids, axis=-1).reshape(-1, len(shape))
    return torch.as_tensor(out.astype(np.float32), device=device).to(dtype)


def fourier_matrix(generator: torch.Generator, mapping_size: int, dim: int,
                   scale: float = 0.5, device: str | torch.device = "cpu") -> torch.Tensor:
    """Gaussian Fourier-feature matrix ``B ~ N(0, 1) * scale`` of shape
    ``(mapping_size, dim)``, drawn from ``generator`` (on the CPU, then moved
    to ``device``, so a seed gives the same B on every device)."""
    B = torch.randn(mapping_size, dim, generator=generator) * scale
    return B.to(device)


def fourier_encode(x: torch.Tensor, B: torch.Tensor | None) -> torch.Tensor:
    """``gamma(x) = [sin(2 pi x B^T), cos(2 pi x B^T)]``; ``B is None`` passes
    ``x`` through. The projection is a true float32 product: TF32 must be off
    on the card (``set_float32_precision``), as the reference runs it at
    precision='highest'."""
    if B is None:
        return x
    proj = (2.0 * math.pi * x) @ B.T
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
