"""Multiresolution dense-grid INR (the ``quality`` and ``fast`` presets).

Counterpart of ``mri_super_resolution_tpu/models/grid_inr.py``: L levels of
dense 3-D feature grids over (x, y, z), trilinearly interpolated, a learned
embedding of the categorical b axis, and a ReLU MLP head
(``_trilinear_gather`` :34, ``GridINR`` :61, ``_axis_weights`` :128,
``_mlp_head`` :141, ``grid_inr_tensor_apply`` :184,
``make_tensor_value_and_grad`` :216, ``infer_tensor_grid`` :402,
``GridINR2D`` :411). The JAX package wrote no Pallas kernel for it, and
neither does the port: both paths are plain PyTorch on every device.
:func:`grid_inr_tensor_apply_batched` and
:func:`make_tensor_value_and_grad_batched` are the tensor path under
``jax.vmap`` (the hybrid fit's four per-TE GridINRs, JAX
``pipelines/hybrid.py:109-137``), the slot axis written out.

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

from mri_super_resolution_tpu_torch.core.coords import linspace_from_zero
from mri_super_resolution_tpu_torch.fit.engine import (
    autodiff_value_and_grad,
    batched_autodiff_value_and_grad,
)

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


@functools.lru_cache(maxsize=256)
def _axis_weights(n: int, R: int, device=None) -> torch.Tensor:
    """(n, R) linear-interpolation matrix from R knots to n uniform samples
    of [0, 1], with the gather path's floor/clip convention. A constant of
    (n, R, device), built once: rebuilding the twelve of a 4-level grid
    took about 300 of the 630 eager ops of a fit step."""
    pos = linspace_from_zero(1.0, n, device) * (R - 1)
    lo = torch.floor(pos).long().clamp(0, R - 2)
    frac = pos - lo.to(pos.dtype)
    return (F.one_hot(lo, R).to(pos.dtype) * (1.0 - frac)[:, None]
            + F.one_hot(lo + 1, R).to(pos.dtype) * frac[:, None])


def _b_slots(nb: int, num_b: int, device) -> torch.Tensor:
    """The embedding slot of each of the tensor path's nb b samples
    (``linspace(0, 1, nb)`` snapped to the nearest of num_b slots, half to
    even as ``jnp.round``)."""
    pos = torch.round(linspace_from_zero(1.0, nb, device) * (num_b - 1)).long()
    return pos.clamp(0, num_b - 1)


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
    b_feat = b_emb[_b_slots(nb, num_b, dev)]  # (nb, bF)
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


# the batched head's weight gradient sums each slot's N rows in this many
# chunks, once N is at least this many rows a chunk
_GRAM_CHUNKS, _GRAM_MIN_ROWS = 32, 256


def _row_chunked_gram(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(D, out, in) products g^T h of (D, N, out) and (D, N, in), summed
    over the N rows in _GRAM_CHUNKS chunks: one batched product over D x
    chunks, then a sum over the chunks (the last N % _GRAM_CHUNKS rows added
    after). cuBLAS runs a batched product with a long reduction axis and a
    small output (64 x 24 over 100,800 rows a slot) on a few thread blocks,
    without the split of the reduction it gives an unbatched ``mm``: on an
    H100 the head's three weight gradients took 6.7 of a batched step's 8.5
    ms of device time that way, and a whole unbatched step 0.8 ms."""
    D, N, out_f = g.shape
    rows = N // _GRAM_CHUNKS
    if rows < _GRAM_MIN_ROWS:
        return torch.bmm(g.transpose(1, 2), h)
    head = rows * _GRAM_CHUNKS
    gc = g[:, :head].reshape(D * _GRAM_CHUNKS, rows, out_f)
    hc = h[:, :head].reshape(D * _GRAM_CHUNKS, rows, h.shape[-1])
    out = torch.bmm(gc.transpose(1, 2), hc).reshape(D, _GRAM_CHUNKS, out_f, -1).sum(1)
    if head < N:
        out = out + torch.bmm(g[:, head:].transpose(1, 2), h[:, head:])
    return out


class _BatchedLinear(torch.autograd.Function):
    """``baddbmm(b, h, W^T)`` of D stacked layers (h (D, N, in), W (D, out,
    in), b (D, out)); the backward's weight gradient through
    :func:`_row_chunked_gram`."""

    @staticmethod
    def forward(ctx, h, W, b):
        ctx.save_for_backward(h, W)
        return torch.baddbmm(b[:, None], h, W.transpose(1, 2))

    @staticmethod
    def backward(ctx, g):
        h, W = ctx.saved_tensors
        dh = torch.bmm(g, W) if ctx.needs_input_grad[0] else None
        return dh, _row_chunked_gram(g, h), g.sum(1)


def _mlp_head_batched(head: Sequence[torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """:func:`_mlp_head` of D stacked heads (each W (D, out, in), b (D, out))
    on (D, N, in) features, as batched products."""
    h = torch.relu(_BatchedLinear.apply(h, head[0], head[1]))
    h = torch.relu(_BatchedLinear.apply(h, head[2], head[3]))
    return _BatchedLinear.apply(h, head[4], head[5])


def grid_inr_tensor_apply_batched(params: Sequence[torch.Tensor],
                                  shape: Sequence[int]) -> torch.Tensor:
    """:func:`grid_inr_tensor_apply` of D stacked GridINRs at once (the JAX
    package's ``jax.vmap`` over the four per-TE fits): each parameter has a
    leading slot axis D, in :meth:`GridINR.params` order (``grid_l`` (D, R,
    R, Rz, F), ``b_embedding`` (D, num_b, bF), the head's W (D, out, in) and
    b (D, out)). Returns (D, prod(shape), out), slot s the unbatched
    function of slot s's params."""
    nx, ny, nz, nb = (int(s) for s in shape)
    L = len(params) - 1 - _HEAD
    dev = params[0].device
    D = params[0].shape[0]
    feats = []
    for l in range(L):
        g = params[l]
        _, Rx, Ry, Rz, _ = g.shape
        t = torch.einsum("xa,dabcf->dxbcf", _axis_weights(nx, Rx, dev), g)
        t = torch.einsum("yb,dxbcf->dxycf", _axis_weights(ny, Ry, dev), t)
        t = torch.einsum("zc,dxycf->dxyzf", _axis_weights(nz, Rz, dev), t)
        feats.append(t)
    xyz = torch.cat(feats, dim=-1)  # (D, nx, ny, nz, L F)
    b_emb = params[L]
    num_b = b_emb.shape[1]
    b_feat = b_emb[:, _b_slots(nb, num_b, dev)]  # (D, nb, bF)
    lf, bf = xyz.shape[-1], b_feat.shape[-1]
    h = torch.cat([xyz[:, :, :, :, None, :].expand(D, nx, ny, nz, nb, lf),
                   b_feat[:, None, None, None].expand(D, nx, ny, nz, nb, bf)],
                  dim=-1).reshape(D, nx * ny * nz * nb, lf + bf)
    return _mlp_head_batched(params[L + 1:], h)


def make_tensor_value_and_grad_batched(shape: Sequence[int]):
    """``vag(params, coords, targets) -> (loss (D,), grads)`` of D stacked
    GridINRs for ``fit_simple_batched``: slot s's loss is the MSE of its
    tensor-path output on ``mgrid(shape)`` against ``targets[s]`` (D, P,
    1); the grads are autograd's of the sum of the D losses, and since the
    slots share no parameter each slot's gradient is its own loss's.
    ``coords`` (which are that grid) is not read."""
    shape = tuple(int(s) for s in shape)

    def apply(params, coords):
        return grid_inr_tensor_apply_batched(params, shape)

    def vag(params, coords, targets):
        return batched_autodiff_value_and_grad(apply, params, coords, targets)

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
