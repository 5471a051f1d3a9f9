"""Spline-baseline rescale and the cubic-spline resample along one axis.
Counterpart of ``mri_super_resolution_tpu/core/interp.py``
(``_gaussian_kernel1d``, ``_gaussian_blur2d`` and ``rescale`` :24-60,
``_cubic_spline_coeffs`` :63, ``resize_along_axis`` :81).

``rescale`` resizes as ``jax.image.resize`` does: ``order=1`` through
``F.interpolate`` (bilinear, half-pixel centres), ``order=0`` with its
nearest rule, and ``order=3`` with Keys' cubic kernel at a = -0.5 whose
weights are renormalised over the taps inside the image. ``F.interpolate``'s
``bicubic`` takes a = -0.75 and clamps the border, another function, so the
cubic weights are formed here as one matrix an axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mri_super_resolution_tpu_torch.core.coords import linspace_from_zero


def _gaussian_kernel1d(sigma: float, radius: int) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _gaussian_blur2d(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of the last two axes, radius ``int(4 sigma +
    0.5)``, reflect padding (scipy ndimage 'mirror'); along each row (the
    last axis) first, then along each column, as the reference does."""
    radius = int(4.0 * sigma + 0.5)
    if radius < 1:
        return img
    k = _gaussian_kernel1d(sigma, radius).to(img.device, img.dtype)
    h, w = img.shape[-2:]
    x = img.reshape(-1, 1, h, w)
    x = F.conv2d(F.pad(x, (radius, radius, 0, 0), mode="reflect"), k.reshape(1, 1, 1, -1))
    x = F.conv2d(F.pad(x, (0, 0, radius, radius), mode="reflect"), k.reshape(1, 1, -1, 1))
    return x.reshape(img.shape)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel at a = -0.5 of |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _cubic_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize(..., 'cubic')`` along one
    axis: half-pixel sample positions, the kernel widened by 1 / scale when
    downscaling (``antialias``), each column divided by its sum, columns
    whose sample lies outside the input zeroed."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """``jax.image.resize(..., 'nearest')``'s source index of each output
    sample: floor((i + 0.5) n_in / n_out), computed in float32."""
    off = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
    return torch.floor(off).long().to(device)


def rescale(img: torch.Tensor, scale: float, anti_aliasing: bool = False,
            order: int = 1) -> torch.Tensor:
    """Resize the last two axes to ``int(n * scale)`` as
    ``jax.image.resize`` does: ``order`` 0 nearest, 1 linear (half-pixel
    centres), 3 cubic (see the module docstring).

    Upscaling takes an integer ``scale >= 1`` (bilinear ``F.interpolate``,
    edge samples held; anti-aliasing is a no-op, as in the reference).
    Downscaling (``scale < 1``) takes ``anti_aliasing=True``, the only way
    either package calls it: a Gaussian prefilter of skimage's sigma
    ``(1 / scale - 1) / 2``, then the resize, which like ``jax.image.resize``
    spreads its triangle kernel over ``1 / scale`` input pixels and
    renormalises the weights at the edges (``antialias=True``)."""
    if order not in (0, 1, 3):
        raise ValueError(f"order must be 0, 1 or 3; got {order}")
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    if scale < 1:
        if not anti_aliasing or scale <= 0:
            raise ValueError("rescale downscales only with anti_aliasing=True and "
                             f"0 < scale < 1; got scale {scale}, anti_aliasing "
                             f"{anti_aliasing}")
        img = _gaussian_blur2d(img, (1.0 / scale - 1.0) / 2.0)
    elif int(scale) != scale:
        raise ValueError(f"rescale upscales by an integer scale >= 1; got {scale}")
    size = (int(h * scale), int(w * scale))
    if order == 0:
        return img[..., _nearest_index(h, size[0], img.device)[:, None],
                   _nearest_index(w, size[1], img.device)[None, :]]
    if order == 3:
        wy = _cubic_weights(h, size[0], img.device).to(img.dtype)
        wx = _cubic_weights(w, size[1], img.device).to(img.dtype)
        return torch.einsum("...hw,hy,wx->...yx", img, wy, wx)
    out = F.interpolate(img.reshape(-1, 1, h, w), size=size, mode="bilinear",
                        align_corners=False, antialias=scale < 1)
    return out.reshape(*lead, *size)


def _cubic_spline_coeffs(n: int, dtype: torch.dtype = torch.float32,
                         device=None) -> torch.Tensor:
    """The (n, n) not-a-knot system ``A @ m = rhs(y)`` for the second
    derivatives m of a cubic spline through n uniform knots (spacing 1):
    interior rows m[i-1] + 4 m[i] + m[i+1], the first and last rows the
    third derivative continuous at the second and penultimate knots."""
    A = torch.zeros(n, n, dtype=dtype, device=device)
    i = torch.arange(1, n - 1, device=device)
    A[i, i - 1] = 1.0
    A[i, i] = 4.0
    A[i, i + 1] = 1.0
    A[0, :3] = A.new_tensor([1.0, -2.0, 1.0])
    A[n - 1, n - 3:] = A.new_tensor([1.0, -2.0, 1.0])
    return A


def resize_along_axis(arr: torch.Tensor, new_size: int = 128, axis: int = 2) -> torch.Tensor:
    """Cubic-spline resample along one axis (the reference's
    ``resize_array``): a not-a-knot cubic spline through the n samples,
    evaluated at ``new_size`` uniform positions over the same span
    (``linspace(0, n - 1, new_size)`` in knot units, each in the interval of
    its lower knot, clipped to [0, n - 2]), the second derivatives from a
    dense solve. On ``arr``'s device and dtype (integers as float32)."""
    if not arr.is_floating_point():
        arr = arr.to(torch.float32)
    arr = torch.movedim(arr, axis, -1)
    n = arr.shape[-1]
    flat = arr.reshape(-1, n)
    A = _cubic_spline_coeffs(n, flat.dtype, flat.device)
    rhs = torch.zeros_like(flat)
    rhs[:, 1:-1] = 6.0 * (flat[:, :-2] - 2.0 * flat[:, 1:-1] + flat[:, 2:])
    m = torch.linalg.solve(A, rhs.T).T  # second derivatives at the knots
    t = linspace_from_zero(n - 1, new_size, flat.device).to(flat.dtype)
    i0 = torch.floor(t).long().clamp(0, n - 2)
    u = t - i0.to(t.dtype)
    y0, y1 = flat[:, i0], flat[:, i0 + 1]
    m0, m1 = m[:, i0], m[:, i0 + 1]
    # the uniform-spacing (h = 1) Hermite form with second derivatives
    vals = (y0 * (1 - u) + y1 * u + ((1 - u) ** 3 - (1 - u)) * m0 / 6.0
            + (u ** 3 - u) * m1 / 6.0)
    return torch.movedim(vals.reshape(*arr.shape[:-1], new_size), -1, axis)
