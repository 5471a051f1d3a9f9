"""INR fit loops and chunked dense-grid inference.

Counterpart of ``mri_super_resolution_tpu/fit/engine.py``: ``fit_simple``
(:57-95), ``fit_ensemble`` (:116-200), ``plain_apply_init`` and
``fit_until`` (:208-291), ``fit_alternating_pn`` (:322-449), ``infer_grid``
(:479-524) and ``infer_dense_grid`` (:566-616). The JAX loops are one
scanned program; here they are Python loops over eager steps. All but
``fit_until`` never wait for the device: each step's loss is written into a
preallocated device tensor, and nothing reads a value back inside a loop.
``fit_until``'s stopping rule needs each step's loss and max |out| on the
host, one small copy a step.

Parameters are lists of tensors (``Siren.weights()`` order); the optimizers
of ``fit/optim.py`` hold them and update them in place. ``apply_fn(params,
x)`` evaluates the INR; ``value_and_grad_fn(params, x, target) -> (loss,
grads)`` replaces autograd for the INR-on-mean steps (the one-pass kernel K1).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from mri_super_resolution_tpu_torch.core.coords import fourier_encode
from mri_super_resolution_tpu_torch.fit.losses import mse, weighted_mse
from mri_super_resolution_tpu_torch.fit.optim import Adam
from mri_super_resolution_tpu_torch.ops.siren_kernel import siren_forward_ref


class FitResult(NamedTuple):
    params: list
    opt: Adam
    losses: torch.Tensor  # per-step loss trace, on the device


class EnsembleResult(NamedTuple):
    params: list
    losses: torch.Tensor  # per-step mean loss over the real slots, on the device
    pred_1x: torch.Tensor  # ensemble-mean prediction on the base grid
    pred_scale: torch.Tensor  # ensemble-mean prediction on the scale-x grid


class FitUntilResult(NamedTuple):
    params: list
    steps: int
    loss: float  # the loss of the last step taken (before its update)
    losses: list  # every step's loss, as read back
    restarts: list  # the 1-based steps after which the params were re-initialised


class AlternatingResult(NamedTuple):
    inr_params: list
    pn_params: list
    losses: torch.Tensor
    inr_opt: Adam
    pn_opt: Adam


def autodiff_value_and_grad(apply_fn: Callable, params: Sequence[torch.Tensor],
                            coords: torch.Tensor, target: torch.Tensor,
                            weights: torch.Tensor | None = None):
    """``(mse(apply_fn(params, coords), target), grads)`` by autograd; with
    ``weights``, the weighted MSE instead."""
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_() for p in params]
        out = apply_fn(leaves, coords)
        loss = mse(out, target) if weights is None else weighted_mse(out, target, weights)
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


def fit_ensemble(
    apply_fn: Callable,
    opt: Adam,
    coords: torch.Tensor,  # (P, d) shared grid
    pixels: torch.Tensor,  # (A, P, 1) per-acquisition targets
    weights: torch.Tensor,  # (A, P, 1) acceptance weights
    eval_coords_1x: torch.Tensor,  # (P, d)
    eval_coords_scale: torch.Tensor,  # (P s^2, d)
    total_steps: int,
    seg: int,
    valid: Sequence[bool] | None = None,  # (A,) real acquisition slots
    weighted_value_and_grad_fn: Callable | None = None,
) -> EnsembleResult:
    """The master.py:137-160 loop over the parameters ``opt`` holds: each
    step does one Adam update per real acquisition slot (weighted MSE), the
    Adam state carried across acquisitions and steps; the last ``seg`` steps
    also evaluate ``apply_fn`` on the 1x and scale-x grids and accumulate the
    predictions, averaged on return. A slot with ``valid`` False is skipped,
    so it leaves the params and the Adam count untouched, as the JAX
    package's masked slots do. A step's loss is the sum of its slots'
    losses over the number of real slots.

    ``weighted_value_and_grad_fn(params, coords, target, w) -> (loss,
    grads)`` replaces autograd for the per-acquisition update (one K1 pass,
    :func:`~mri_super_resolution_tpu_torch.ops.siren_kernel.make_fused_weighted_value_and_grad`)."""
    params = opt.params
    dev = coords.device
    slots = [a for a in range(pixels.shape[0]) if valid is None or bool(valid[a])]
    n_valid = max(len(slots), 1)
    out_f = pixels.shape[-1]
    losses = torch.empty(total_steps, dtype=torch.float32, device=dev)
    acc1 = torch.zeros(eval_coords_1x.shape[0], out_f, dtype=torch.float32, device=dev)
    acc2 = torch.zeros(eval_coords_scale.shape[0], out_f, dtype=torch.float32, device=dev)
    for step in range(total_steps):
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for a in slots:
            vag = weighted_value_and_grad_fn or functools.partial(
                autodiff_value_and_grad, apply_fn)
            loss, grads = vag(params, coords, pixels[a], weights[a])
            opt.step(grads)
            total += loss
        losses[step] = total / n_valid
        if step >= total_steps - seg:
            with torch.no_grad():
                acc1 += apply_fn(params, eval_coords_1x)
                acc2 += apply_fn(params, eval_coords_scale)
    return EnsembleResult(params, losses, acc1 / seg, acc2 / seg)


def plain_apply(model):
    """``apply_fn(params, x)``: the plain forward of a port ``Siren`` (or
    ``SirenToy``'s trunk) over the weights ``params`` (``model.weights()``
    order), differentiable; for the autograd fits of the toy CLIs."""
    omegas, acts = model.omegas, model.acts
    return lambda params, x: siren_forward_ref(x, params, omegas, acts)


def plain_apply_init(model, generator: torch.Generator | None = None):
    """``(apply_fn, init_fn)`` of a perturbation-style model (``SirenERD``)
    with the perturbation off, for :func:`fit_until`:
    ``apply_fn(params, coords)`` is the trunk's plain forward over the trunk
    weights; ``init_fn(k)`` re-initialises ``model`` in place with fresh
    draws from ``generator`` (as ``init_fn`` of the JAX package draws from a
    fresh key, perturbation branch included) and returns its trunk weights,
    the tensors the fit trains. ``k`` (0 first, then each restart) is not
    read: the draws continue along the generator."""
    omega, acts = float(model.hidden_omega_0), tuple(model.acts)

    def apply_fn(params, coords):
        return siren_forward_ref(coords, params, omega, acts)

    def init_fn(k: int):
        fresh = type(model)(**model.config, generator=generator)
        with torch.no_grad():
            model.load_state_dict(fresh.state_dict())
        return model.weights()

    return apply_fn, init_fn


def fit_until(apply_fn: Callable, lr: float, init_fn: Callable[[int], list],
              coords: torch.Tensor, target: torch.Tensor, loss_threshold: float = 2e-5,
              max_steps: int = 200_000,
              value_grad_absmax_fn: Callable | None = None) -> FitUntilResult:
    """Train until the loss is at most ``loss_threshold``, re-initialising
    the params and a fresh Adam whenever the output collapses to all zero
    (INR_ERD.py:201-217), at most ``max_steps`` steps. Step by step as the
    JAX ``while_loop``: the loop goes on while the loss of the step just
    taken (computed before its update) is above the threshold; the collapse
    test reads that step's max |out| after its update; a restart draws
    ``init_fn(number of restarts so far)``.

    ``value_grad_absmax_fn(params, coords, target) -> (loss, out_absmax,
    grads)`` replaces autograd with one K1 pass that also returns the
    collapse signal (:func:`~mri_super_resolution_tpu_torch.ops.siren_kernel.make_fused_value_grad_absmax`).
    Each step copies its loss and max |out| to the host once."""
    params = init_fn(0)
    opt = Adam(params, lr)
    loss, it = float("inf"), 0
    losses, restarts = [], []
    while loss > loss_threshold and it < max_steps:
        if value_grad_absmax_fn is not None:
            loss_t, absmax_t, grads = value_grad_absmax_fn(params, coords, target)
        else:
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_() for p in params]
                out = apply_fn(leaves, coords)
                loss_t = mse(out, target)
                grads = torch.autograd.grad(loss_t, leaves)
            loss_t, absmax_t = loss_t.detach(), out.detach().abs().max()
        opt.step(grads)
        loss, absmax = torch.stack([loss_t, absmax_t]).tolist()
        losses.append(loss)
        it += 1
        if absmax == 0.0:
            restarts.append(it)
            params = init_fn(len(restarts))
            opt = Adam(params, lr)
    return FitUntilResult(params, it, loss, losses, restarts)


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
