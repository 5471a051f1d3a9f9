"""Coordinate grids and Fourier-feature encodings.

Counterpart of ``mri_super_resolution_tpu/core/coords.py`` (``mgrid``
:24-42, ``mgrid_square`` :45, ``fourier_matrix`` :50-59, ``fourier_encode``
:62-75, ``chunked_coords`` :84-91), and :func:`linspace_from_zero`,
the ``jnp.linspace(0, stop, n)`` that the grid INR's and the spline's
sample positions are built from.
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


def linspace_from_zero(stop: float, n: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0, stop, n)`` in float32 as XLA computes it, bit for
    bit: i times (the float32 reciprocal of n - 1 times ``stop``), the last
    point exactly ``stop`` (``torch.linspace`` and i stop / (n - 1) round
    some points to the other side of ``floor``)."""
    step = float(np.float32(1.0) / np.float32(max(n - 1, 1)) * np.float32(stop))
    out = torch.arange(n, dtype=torch.float32, device=device) * step
    if n > 1:
        out[-1] = float(np.float32(stop))
    return out


def mgrid_square(sidelen: int, dim: int = 2, device: str | torch.device = "cpu",
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The ``get_mgrid(sidelen, dim)`` variant: a square (cubic, ...) grid."""
    return mgrid((sidelen,) * dim, device=device, dtype=dtype)


def chunked_coords(shape: Sequence[int], chunk: int) -> list[np.ndarray]:
    """The dense grid of ``shape`` as host-side float32 row chunks of at most
    ``chunk`` rows, for memory-bounded inference."""
    full = mgrid(shape).numpy()
    return [full[i:i + chunk] for i in range(0, full.shape[0], chunk)]


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
