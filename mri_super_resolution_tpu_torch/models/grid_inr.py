"""Multiresolution dense-grid INR (the ``quality`` and ``fast`` presets).

Counterpart of ``mri_super_resolution_tpu/models/grid_inr.py``: L levels of
dense 3-D feature grids over (x, y, z), trilinearly interpolated, a learned
embedding of the categorical b axis, and a ReLU MLP head
(``_trilinear_gather`` :34, ``GridINR`` :61, ``_axis_weights`` :128,
``_mlp_head`` :141, ``grid_inr_tensor_apply`` :184,
``make_tensor_value_and_grad`` :216, ``infer_tensor_grid`` :402,
``GridINR2D`` :411). The JAX package wrote no Pallas kernel for it, and
neither does the port: both paths are plain PyTorch on every device.

Two evaluations of the same function:

- the gather path (:func:`grid_inr_apply`, the module's ``forward``) at any
  (N, 4) coordinates; the PerturbNet steps differentiate through it, and its
  backward scatter-adds into the grids (with atomics on a CUDA device, so
  the order of the float32 sums changes from run to run);
- the tensor path (:func:`grid_inr_tensor_apply`) on the tensor-product grid
  ``mgrid(shape)`` itself: trilinear interpolation is separable there, so a
  level's features for the whole grid are three small contractions with
  per-axis interpolation matrices (:func:`_axis_weights`). The mean-fit
  steps and every dense inference take it.

The JAX package's z buckets (``z_bucket_for`` :257, ``build_z_aux`` :270,
``make_zbucket_value_and_grad`` :299, ``pad_target_z`` :327,
``infer_tensor_grid_zbucket`` :374) are not ported: they pad the slice axis
to a power of two only to bound XLA recompiles. Their masked MSE divides by
the true voxel count and the padded rows get zero weight, so the unpadded
fit here computes the same loss and gradients.

Parameters, as a list in :meth:`GridINR.params` order: ``grid_0 ..
grid_{L-1}`` (R, R, Rz, F) (``GridINR2D``: (R, R, F)), then (3-D only) the
``b_embedding`` (num_b, b_features), then the head's ``[W0, b0, W1, b1, W2,
b2]`` in ``nn.Linear`` layout (W is (out, in)). The functions read L and
num_b from the shapes.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mri_super_resolution_tpu_torch.fit.engine import autodiff_value_and_grad

_HEAD = 6  # W0, b0, W1, b1, W2, b2 of the MLP head


def lecun_dense(in_f: int, out_f: int, generator, device) -> nn.Linear:
    """flax ``nn.Dense``'s initialisation: lecun_normal W (a normal of
    variance 1/in truncated at two standard deviations) and zero bias."""
    layer = nn.Linear(in_f, out_f, device=device)
    with torch.no_grad():
        std = math.sqrt(1.0 / in_f) / 0.87962566103423978
        w = torch.empty(out_f, in_f)
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        layer.weight.copy_(w)
        layer.bias.zero_()
    return layer


def level_resolution(base_resolution: int, growth: float, level: int) -> int:
    return int(round(base_resolution * growth ** level))


def _head(d_in: int, hidden: int, out_features: int, generator, device) -> nn.ModuleList:
    """The ReLU MLP head's three Dense layers (flax ``Dense_0..2``)."""
    return nn.ModuleList([lecun_dense(d_in, hidden, generator, device),
                          lecun_dense(hidden, hidden, generator, device),
                          lecun_dense(hidden, out_features, generator, device)])


def _head_params(head: nn.ModuleList) -> list[torch.Tensor]:
    return [t for lin in head for t in (lin.weight, lin.bias)]


def _trilinear_gather(grid: torch.Tensor, coords01: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of a dense (R1, R2, R3, F) grid at (N, 3)
    coordinates in [0, 1]^3; the lower corner floored and clipped to
    [0, R - 2] on each axis."""
    dims = torch.tensor(grid.shape[:3], device=coords01.device)
    pos = coords01 * (dims.to(coords01.dtype) - 1.0)
    lo = torch.minimum(torch.floor(pos).long().clamp_min(0), dims - 2)
    frac = pos - lo.to(coords01.dtype)
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((frac[:, 0] if dx else 1 - frac[:, 0])
                     * (frac[:, 1] if dy else 1 - frac[:, 1])
                     * (frac[:, 2] if dz else 1 - frac[:, 2]))
                vals = grid[lo[:, 0] + dx, lo[:, 1] + dy, lo[:, 2] + dz]
                out = out + w[:, None] * vals
    return out


def _mlp_head(head: Sequence[torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    h = torch.relu(h @ head[0].T + head[1])
    h = torch.relu(h @ head[2].T + head[3])
    return h @ head[4].T + head[5]


def _unit_linspace(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` in float32 as XLA computes it, bit for bit:
    i times the float32 reciprocal of n - 1, the last point exactly 1
    (``torch.linspace`` and i / (n - 1) round some knots to the other side
    of ``floor``)."""
    step = float(np.float32(1.0) / np.float32(max(n - 1, 1)))
    out = torch.arange(n, dtype=torch.float32, device=device) * step
    if n > 1:
        out[-1] = 1.0
    return out


@functools.lru_cache(maxsize=256)
def _axis_weights(n: int, R: int, device=None) -> torch.Tensor:
    """(n, R) linear-interpolation matrix from R knots to n uniform samples
    of [0, 1], with the gather path's floor/clip convention. A constant of
    (n, R, device), built once: rebuilding the twelve of a 4-level grid
    took about 300 of the 630 eager ops of a fit step."""
    pos = _unit_linspace(n, device) * (R - 1)
    lo = torch.floor(pos).long().clamp(0, R - 2)
    frac = pos - lo.to(pos.dtype)
    return (F.one_hot(lo, R).to(pos.dtype) * (1.0 - frac)[:, None]
            + F.one_hot(lo + 1, R).to(pos.dtype) * frac[:, None])


def grid_inr_apply(params: Sequence[torch.Tensor], coords: torch.Tensor) -> torch.Tensor:
    """The gather path: :class:`GridINR` at (N, 4) coordinates in [-1, 1]
    (the 4th the b axis, snapped to the nearest embedding slot, half to even
    as ``jnp.round``). Differentiable in ``params`` and ``coords``."""
    L = len(params) - 1 - _HEAD
    b_emb = params[L]
    num_b = b_emb.shape[0]
    xyz01 = torch.clamp((coords[:, :3] + 1.0) * 0.5, 0.0, 1.0)
    b_idx = torch.round((coords[:, 3] + 1.0) * 0.5 * (num_b - 1)).long().clamp(0, num_b - 1)
    feats = [_trilinear_gather(params[l], xyz01) for l in range(L)]
    feats.append(b_emb[b_idx])
    return _mlp_head(params[L + 1:], torch.cat(feats, dim=-1))


def grid_inr_tensor_apply(params: Sequence[torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """The tensor path: :class:`GridINR` on every point of ``mgrid(shape)``
    (shape (nx, ny, nz, nb)) by separable contractions; returns
    (prod(shape), out) in mgrid's row order."""
    nx, ny, nz, nb = (int(s) for s in shape)
    L = len(params) - 1 - _HEAD
    dev = params[0].device
    feats = []
    for l in range(L):
        g = params[l]
        Rx, Ry, Rz, _ = g.shape
        t = torch.einsum("xa,abcf->xbcf", _axis_weights(nx, Rx, dev), g)
        t = torch.einsum("yb,xbcf->xycf", _axis_weights(ny, Ry, dev), t)
        t = torch.einsum("zc,xycf->xyzf", _axis_weights(nz, Rz, dev), t)
        feats.append(t)
    xyz = torch.cat(feats, dim=-1)  # (nx, ny, nz, L F)
    b_emb = params[L]
    num_b = b_emb.shape[0]
    b_pos = torch.round(_unit_linspace(nb, dev) * (num_b - 1)).long().clamp(0, num_b - 1)
    b_feat = b_emb[b_pos]  # (nb, bF)
    lf, bf = xyz.shape[-1], b_feat.shape[-1]
    h = torch.cat([xyz[:, :, :, None, :].expand(nx, ny, nz, nb, lf),
                   b_feat[None, None, None].expand(nx, ny, nz, nb, bf)],
                  dim=-1).reshape(nx * ny * nz * nb, lf + bf)
    return _mlp_head(params[L + 1:], h)


def make_tensor_apply(shape: Sequence[int]):
    """``apply(params, coords)`` for the fit engine: the tensor path on
    ``mgrid(shape)``; ``coords`` (which are that grid) is not read."""
    shape = tuple(int(s) for s in shape)

    def apply(params, coords):
        return grid_inr_tensor_apply(params, shape)

    return apply


def make_tensor_value_and_grad(shape: Sequence[int]):
    """``vag(params, coords, target) -> (loss, grads)`` for the fit engine:
    the MSE through the tensor path by autograd (``coords`` not read)."""
    apply = make_tensor_apply(shape)

    def vag(params, coords, target):
        return autodiff_value_and_grad(apply, params, coords, target)

    return vag


@torch.no_grad()
def infer_tensor_grid(params: Sequence[torch.Tensor], shape: Sequence[int],
                      clamp_min: float | None = None) -> np.ndarray:
    """Dense inference on ``mgrid(shape)`` by the tensor path (no coordinate
    array, no chunks); returns a host (prod(shape), out) array, as
    ``fit.engine.infer_dense_grid`` does."""
    out = grid_inr_tensor_apply(params, shape)
    if clamp_min is not None:
        out = out.clamp_min(clamp_min)
    return out.cpu().numpy()


class GridINR(nn.Module):
    """Multiresolution dense-grid INR over [-1, 1]^3 x {0 .. num_b - 1}.

    Level l has resolution R = round(base_resolution growth^l) in-plane and
    max(R // z_divisor, 2) on z, F = ``features_per_level`` features, drawn
    U[0, 1e-4); the embedding is N(0, 1e-2); the head's Dense layers
    lecun_normal with zero bias (flax's defaults)."""

    def __init__(self, num_levels: int = 4, base_resolution: int = 8,
                 growth: float = 2.0, features_per_level: int = 4, num_b: int = 4,
                 b_features: int = 8, hidden: int = 64, out_features: int = 1,
                 z_divisor: int = 4, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        grids = []
        for l in range(num_levels):
            R = level_resolution(base_resolution, growth, l)
            g = torch.rand(R, R, max(R // z_divisor, 2), features_per_level,
                           generator=generator) * 1e-4
            grids.append(nn.Parameter(g.to(device)))
        self.grids = nn.ParameterList(grids)
        emb = torch.randn(num_b, b_features, generator=generator) * 1e-2
        self.b_embedding = nn.Parameter(emb.to(device))
        self.head = _head(num_levels * features_per_level + b_features, hidden,
                          out_features, generator, device)

    def params(self) -> list[torch.Tensor]:
        """Every parameter, in the functions' order."""
        return [*self.grids, self.b_embedding, *_head_params(self.head)]

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        return grid_inr_apply(self.params(), coords)


def grid_inr2d_apply(params: Sequence[torch.Tensor], coords: torch.Tensor) -> torch.Tensor:
    """:class:`GridINR2D` at (N, 2) coordinates in [-1, 1]: bilinear, through
    the trilinear gather on each grid with its plane doubled on z."""
    L = len(params) - _HEAD
    xy01 = torch.clamp((coords + 1.0) * 0.5, 0.0, 1.0)
    c3 = torch.cat([xy01, torch.zeros_like(xy01[:, :1])], dim=-1)
    feats = [_trilinear_gather(torch.stack([params[l]] * 2, dim=2), c3) for l in range(L)]
    return _mlp_head(params[L:], torch.cat(feats, dim=-1))


class GridINR2D(nn.Module):
    """2-D variant for slice fitting: bilinear (R, R, F) grids, no b axis."""

    def __init__(self, num_levels: int = 4, base_resolution: int = 8,
                 growth: float = 2.0, features_per_level: int = 4, hidden: int = 64,
                 out_features: int = 1, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        grids = []
        for l in range(num_levels):
            R = level_resolution(base_resolution, growth, l)
            g = torch.rand(R, R, features_per_level, generator=generator) * 1e-4
            grids.append(nn.Parameter(g.to(device)))
        self.grids = nn.ParameterList(grids)
        self.head = _head(num_levels * features_per_level, hidden, out_features,
                          generator, device)

    def params(self) -> list[torch.Tensor]:
        return [*self.grids, *_head_params(self.head)]

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        return grid_inr2d_apply(self.params(), coords)
