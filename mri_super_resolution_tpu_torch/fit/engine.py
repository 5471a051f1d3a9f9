"""INR fit loops and chunked dense-grid inference.

Counterpart of ``mri_super_resolution_tpu/fit/engine.py``: ``fit_simple``
(:57-95), ``fit_alternating_pn`` (:322-449), ``infer_grid`` (:479-524) and
``infer_dense_grid`` (:566-616). The JAX loops are one scanned program; here
they are Python loops over eager steps that never wait for the device: each
step's loss is written into a preallocated device tensor, and nothing reads a
value back inside a loop.

Parameters are lists of tensors (``Siren.weights()`` order); the optimizers
of ``fit/optim.py`` hold them and update them in place. ``apply_fn(params,
x)`` evaluates the INR; ``value_and_grad_fn(params, x, target) -> (loss,
grads)`` replaces autograd for the INR-on-mean steps (the one-pass kernel K1).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from mri_super_resolution_tpu_torch.core.coords import fourier_encode
from mri_super_resolution_tpu_torch.fit.losses import mse
from mri_super_resolution_tpu_torch.fit.optim import Adam


class FitResult(NamedTuple):
    params: list
    opt: Adam
    losses: torch.Tensor  # per-step loss trace, on the device


class AlternatingResult(NamedTuple):
    inr_params: list
    pn_params: list
    losses: torch.Tensor
    inr_opt: Adam
    pn_opt: Adam


def autodiff_value_and_grad(apply_fn: Callable, params: Sequence[torch.Tensor],
                            coords: torch.Tensor, target: torch.Tensor):
    """``(mse(apply_fn(params, coords), target), grads)`` by autograd."""
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_() for p in params]
        loss = mse(apply_fn(leaves, coords), target)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def fit_simple(apply_fn: Callable, opt: Adam, coords: torch.Tensor,
               target: torch.Tensor, num_steps: int,
               value_and_grad_fn: Callable | None = None) -> FitResult:
    """``num_steps`` full-batch MSE steps on (coords -> target) of the
    parameters ``opt`` holds; calling again continues its moments."""
    losses = torch.empty(num_steps, dtype=torch.float32, device=coords.device)
    for i in range(num_steps):
        if value_and_grad_fn is not None:
            loss, grads = value_and_grad_fn(opt.params, coords, target)
        else:
            loss, grads = autodiff_value_and_grad(apply_fn, opt.params, coords, target)
        opt.step(grads)
        losses[i] = loss
    return FitResult(opt.params, opt, losses)


def fit_alternating_pn(
    inr_apply: Callable,
    pn_apply: Callable,
    inr_opt: Adam,
    pn_opt: Adam,
    ff_coords: torch.Tensor,  # (P, 2m) Fourier-encoded LR grid (raw for WIRE)
    mean_target: torch.Tensor,  # (P, 1) LR mean image
    acq_pixels: torch.Tensor,  # (A, P, 1) per-acquisition targets
    B: torch.Tensor,  # Fourier matrix, for the double mapping of PN output
    num_epochs: int = 2500,
    pn_epochs: int = 10,
    pn_eps: float = 1.0 / 128.0,
    inr_value_and_grad: Callable | None = None,
    phase2_start: int | None = None,
    pn_encode: Callable | None = None,
) -> AlternatingResult:
    """superresDWI.py:132-156: ``num_epochs - pn_epochs`` INR-on-mean steps,
    then ``pn_epochs`` alternating steps at absolute epoch indices from
    ``phase2_start`` (default ``num_epochs - pn_epochs``) -- odd: one
    INR-on-mean step; even: one PN-only Adam step per acquisition, the PN's
    Adam state carried across acquisitions and epochs.

    Quirk kept: the PN reads the *encoded* coords and its output is
    Fourier-encoded again before the INR, so the INR sees
    gamma(PN(gamma(x))). ``pn_encode`` maps the PN output to the INR's input
    instead; models that take raw coordinates (WIRE) pass identity. The
    kernels mask ragged rows themselves, so there are no padded copies of
    ``ff_coords`` or ``mean_target``."""
    inr_params, pn_params = inr_opt.params, pn_opt.params
    losses = torch.empty(num_epochs, dtype=torch.float32, device=ff_coords.device)

    def inr_step():
        if inr_value_and_grad is not None:
            loss, grads = inr_value_and_grad(inr_params, ff_coords, mean_target)
        else:
            loss, grads = autodiff_value_and_grad(inr_apply, inr_params, ff_coords,
                                                  mean_target)
        inr_opt.step(grads)
        return loss

    n1 = num_epochs - pn_epochs
    for i in range(n1):
        losses[i] = inr_step()

    n_acq = acq_pixels.shape[0]
    start = n1 if phase2_start is None else phase2_start
    for j, epoch in enumerate(range(start, start + pn_epochs)):
        if epoch % 2 == 1:
            losses[n1 + j] = inr_step()
            continue
        inr_frozen = [p.detach() for p in inr_params]
        total = torch.zeros((), dtype=torch.float32, device=ff_coords.device)
        for a in range(n_acq):
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_() for p in pn_params]
                perturbed = pn_apply(leaves, ff_coords, float(a), pn_eps)
                enc = (fourier_encode(perturbed, B) if pn_encode is None
                       else pn_encode(perturbed))
                loss = mse(inr_apply(inr_frozen, enc), acq_pixels[a])
                grads = torch.autograd.grad(loss, leaves)
            pn_opt.step(grads)
            total += loss.detach()
        losses[n1 + j] = total / n_acq
    return AlternatingResult(inr_params, pn_params, losses, inr_opt, pn_opt)


@torch.no_grad()
def infer_grid(apply_fn: Callable, params, coords: torch.Tensor,
               chunk: int = 262_144, clamp_min: float | None = None,
               fourier_B: torch.Tensor | None = None) -> torch.Tensor:
    """The INR on the given (P, d) coordinates in chunks of ``chunk`` rows
    (encoded with ``fourier_B`` when given); returns (P, out)."""
    outs = []
    for i in range(0, coords.shape[0], chunk):
        x = fourier_encode(coords[i:i + chunk], fourier_B)
        out = apply_fn(params, x)
        outs.append(out if clamp_min is None else out.clamp_min(clamp_min))
    return torch.cat(outs, dim=0)


@torch.no_grad()
def infer_dense_grid(apply_fn: Callable, params, grid_shape: Sequence[int],
                     chunk: int = 262_144, clamp_min: float | None = None,
                     fourier_B: torch.Tensor | None = None,
                     device: str | torch.device | None = None) -> np.ndarray:
    """The INR on the dense ``mgrid(grid_shape)`` without building it: each
    chunk's coordinates are made on the device from the row indices
    (coordinate -1 + 2 j / (n - 1) on an axis of size n, -1 when n == 1).
    Returns a host ``(P, out)`` array. Grids of 2^31 voxels or more are
    refused, as the reference refuses them."""
    sizes = [int(s) for s in grid_shape]
    P = math.prod(sizes)
    if P >= 2 ** 31:
        raise ValueError(
            f"infer_dense_grid: grid {tuple(sizes)} has {P} voxels, which "
            "overflows the reference's int32 index math; evaluate in "
            "sub-volumes instead")
    if device is None:
        device = fourier_B.device if fourier_B is not None else params[0].device
    chunk = min(int(chunk), 1 << (P - 1).bit_length())
    sizes_t = torch.tensor(sizes, dtype=torch.int64, device=device)
    strides = torch.tensor([math.prod(sizes[a + 1:]) for a in range(len(sizes))],
                           dtype=torch.int64, device=device)
    denom = torch.clamp(sizes_t - 1, min=1).to(torch.float32)
    outs = []
    for start in range(0, P, chunk):
        i = torch.arange(start, min(start + chunk, P), dtype=torch.int64, device=device)
        idx = (i[:, None] // strides[None, :]) % sizes_t[None, :]
        c = -1.0 + 2.0 * idx.to(torch.float32) / denom
        out = apply_fn(params, fourier_encode(c, fourier_B))
        outs.append(out if clamp_min is None else out.clamp_min(clamp_min))
    return torch.cat(outs, dim=0).cpu().numpy()
