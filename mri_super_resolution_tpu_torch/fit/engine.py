"""INR fit loops and chunked dense-grid inference.

Counterpart of ``mri_super_resolution_tpu/fit/engine.py``: ``fit_simple``
(:57-95), ``plain_apply_init`` and ``fit_until`` (:208-291),
``fit_alternating_pn`` (:322-449), ``infer_grid`` (:479-524) and
``infer_dense_grid`` (:566-616); :func:`fit_simple_batched` and
:func:`fit_ensemble_batched` are ``fit_simple`` and ``fit_ensemble``
(:116-200) under ``jax.vmap`` (the hybrid fit's four TEs, the 2-D
ensemble's three directions; one model is D = 1), the batch axis written
out: one batched value-and-grad call (K1's, or the grid INR's tensor path)
and one :class:`~mri_super_resolution_tpu_torch.fit.optim.StackedAdam` step
an update for every slot. The JAX loops are one scanned program; here they
are Python loops over eager steps. All but ``fit_until`` never wait for the
device: each step's loss is written into a preallocated device tensor, and
nothing reads a value back inside a loop. ``fit_until``'s stopping rule
needs each step's loss and max |out| on the host, one small copy a step.

Parameters are lists of tensors (``Siren.weights()`` order); the optimizers
of ``fit/optim.py`` hold them and update them in place. ``apply_fn(params,
x)`` evaluates the INR; ``value_and_grad_fn(params, x, target) -> (loss,
grads)`` replaces autograd for the INR-on-mean steps (the one-pass kernel K1).

``fit_ensemble_batched``, ``fit_alternating_pn`` and ``fit_until`` take a
``mesh`` (``parallel/mesh.py``): the JAX functions run unchanged on voxel
rows sharded over a device mesh, and this is their form over ranks. Every
row-indexed input is then this rank's equal shard of the voxel axis
(``parallel.mesh.shard_batch``), the params and optimizer state are
replicated, and each kernel (or autograd) call's loss and gradients, scaled
by P_local / P, are summed over the ``data`` axis in one ``all_reduce``
before the optimizer step, which every rank takes alike. The losses divide
by the total row count (the weighted MSE by the element count, not the
weight sum), so the sum is the whole batch's. Without a mesh, or with a
``data`` axis of one rank, they run as unsharded code, op for op.

Spans (``utils/profiling.py``; they record only while a profiler runs):
``fit.inr_step`` and ``fit.pn_step`` around each step of
``fit_alternating_pn``, ``infer.request`` around ``infer_dense_grid`` and,
inside it, ``infer.grid``, ``infer.chunk`` (``infer.coords``,
``infer.encode`` and the INR's call), ``infer.gather`` and
``infer.to_host``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from mri_super_resolution_tpu_torch.core.coords import fourier_encode
from mri_super_resolution_tpu_torch.fit.losses import mse
from mri_super_resolution_tpu_torch.fit.optim import Adam, StackedAdam
from mri_super_resolution_tpu_torch.ops.siren_kernel import siren_forward_ref
from mri_super_resolution_tpu_torch.utils.profiling import span


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


def _mesh_ops():
    """``parallel/mesh.py``, imported at first use: ``parallel/`` imports
    this module."""
    from mri_super_resolution_tpu_torch.parallel import mesh

    return mesh


def _data_scale(mesh, device: torch.device, **rows: int) -> float | None:
    """``None`` without ``mesh`` or with a ``data`` axis of one rank: the
    fit runs unsharded. Else P_local / P of the first of ``rows`` (input
    name -> this rank's row count); raises ``ValueError`` unless every rank
    of the data row holds as many rows of each (one ``all_reduce``)."""
    if mesh is None or mesh.group("data") is None:
        return None
    counts = _mesh_ops().axis_counts(list(rows.values()), mesh, "data", device)
    for j, name in enumerate(rows):
        if len(set(counts[:, j].tolist())) > 1:
            raise ValueError(
                f"{name}: the {len(counts)} ranks of the data axis hold "
                f"{counts[:, j].tolist()} rows; each needs an equal shard "
                "(parallel.mesh.shard_batch)")
    return float(counts[0, 0]) / float(counts[:, 0].sum())


def _reduce(mesh, scale: float | None, loss: torch.Tensor, grads):
    """``(loss, grads)`` summed over the data row after scaling by
    ``scale`` (one ``all_reduce`` of one flat buffer); as they are when
    ``scale`` is None."""
    if scale is None:
        return loss, list(grads)
    loss, *grads = _mesh_ops().all_reduce_sum([loss * scale, *(g * scale for g in grads)],
                                              mesh, "data")
    return loss, grads


def autodiff_value_and_grad(apply_fn: Callable, params: Sequence[torch.Tensor],
                            coords: torch.Tensor, target: torch.Tensor):
    """``(mse(apply_fn(params, coords), target), grads)`` by autograd."""
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_() for p in params]
        out = apply_fn(leaves, coords)
        loss = mse(out, target)
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


def batched_autodiff_value_and_grad(apply_fn: Callable, params: Sequence[torch.Tensor],
                                    coords: torch.Tensor, target: torch.Tensor,
                                    weights: torch.Tensor | None = None):
    """``(loss (D,), grads)`` of D stacked models by autograd:
    ``apply_fn(params, coords)`` is (D, P, out), each slot's loss the MSE
    (with ``weights``, the weighted MSE) of its output and ``target[s]``."""
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_() for p in params]
        sq = (apply_fn(leaves, coords) - target) ** 2
        loss = (sq if weights is None else weights * sq).mean(dim=(1, 2))
        grads = torch.autograd.grad(loss.sum(), leaves)
    return loss.detach(), list(grads)


def fit_simple_batched(opt: StackedAdam, coords: torch.Tensor, targets: torch.Tensor,
                       num_steps: int, value_and_grad_fn: Callable) -> FitResult:
    """``fit_simple`` over D slots at once (``jax.vmap`` of the JAX
    ``fit_simple``, as the hybrid fit runs its four TEs): ``num_steps``
    full-batch MSE steps of the stacked params ``opt`` holds, slot s on
    (coords -> ``targets[s]``). ``value_and_grad_fn(params, coords, targets)
    -> (loss (D,), grads)`` is the batched K1
    (:func:`~mri_super_resolution_tpu_torch.ops.siren_kernel.make_fused_value_and_grad_batched`,
    the SIREN arm) or the grid INR's batched tensor path
    (:func:`~mri_super_resolution_tpu_torch.models.grid_inr.make_tensor_value_and_grad_batched`,
    the grid arm). The loss trace is (num_steps, D)."""
    D = targets.shape[0]
    losses = torch.empty(num_steps, D, dtype=torch.float32, device=coords.device)
    for i in range(num_steps):
        loss, grads = value_and_grad_fn(opt.params, coords, targets)
        opt.step(grads)
        losses[i] = loss
    return FitResult(opt.params, opt, losses)


def fit_ensemble_batched(
    apply_fn: Callable,
    opt: StackedAdam,
    coords: torch.Tensor,  # (P, d) shared grid
    pixels: torch.Tensor,  # (D, A, P, 1) per-direction, per-acquisition targets
    weights: torch.Tensor,  # (D, A, P, 1) acceptance weights
    eval_coords_1x: torch.Tensor,  # (P, d)
    eval_coords_scale: torch.Tensor,  # (P s^2, d)
    total_steps: int,
    seg: int,
    valid: np.ndarray | None = None,  # (D, A) real acquisition slots
    weighted_value_and_grad_fn: Callable | None = None,
    mesh=None,
) -> EnsembleResult:
    """The master.py:137-160 loop (``fit_ensemble`` of the JAX package)
    over D directions at once, as the JAX package runs it under ``jax.vmap``
    (pipelines/master2d.py:157): each step runs acquisition slots a = 0 ..
    A - 1, each one batched update of the D stacked models ``opt`` holds on
    ``pixels[:, a]`` and ``weights[:, a]``, the Adam state carried across
    acquisitions and steps.
    A direction whose slot a is not ``valid`` (padded: fewer acquisitions
    than the longest direction) is still computed, as under ``vmap``, but
    its loss counts 0 and ``opt.step``'s mask leaves its params, moments
    and count untouched. A step's loss per direction is the sum of its real
    slots' losses over their number. The last ``seg`` steps accumulate
    ``apply_fn(params, x) -> (D, P, out)`` on the 1x and scale-x grids.

    ``weighted_value_and_grad_fn(params, coords, targets, w) -> (loss (D,),
    grads)`` is the batched K1 with sample weights
    (:func:`~mri_super_resolution_tpu_torch.ops.siren_kernel.make_fused_weighted_value_and_grad_batched`),
    else autograd through ``apply_fn`` (``use_pallas=False``, the CPU's
    plain route). Returns the stacked params, the (total_steps, D) loss
    trace and (D, P, out) predictions.

    With ``mesh``, ``coords``, ``pixels``, ``weights`` (their P axis) and
    both eval grids are this rank's shards: each slot's call runs on the
    local rows and its ``(loss (D,), grads)`` are reduced before the step;
    the predictions, made on each rank's eval rows, are gathered once at
    the end (through the CPU), so the result has the one-rank shapes."""
    dev = coords.device
    scale = _data_scale(mesh, dev, coords=coords.shape[0], eval_coords_1x=eval_coords_1x.shape[0],
                        eval_coords_scale=eval_coords_scale.shape[0])
    D, A = pixels.shape[:2]
    valid = np.ones((D, A), dtype=bool) if valid is None else np.asarray(valid, dtype=bool)
    n_valid = torch.as_tensor(np.maximum(valid.sum(1), 1), dtype=torch.float32, device=dev)
    valid_t = torch.as_tensor(valid, device=dev)
    # slot a of every direction contiguous, as the kernels take targets
    pixels = pixels.transpose(0, 1).contiguous()
    weights = weights.transpose(0, 1).contiguous()
    slots = [a for a in range(A) if valid[:, a].any()]
    out_f = pixels.shape[-1]
    losses = torch.empty(total_steps, D, dtype=torch.float32, device=dev)
    acc1 = torch.zeros(D, eval_coords_1x.shape[0], out_f, dtype=torch.float32, device=dev)
    acc2 = torch.zeros(D, eval_coords_scale.shape[0], out_f, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for step in range(total_steps):
        total = torch.zeros(D, dtype=torch.float32, device=dev)
        for a in slots:
            if weighted_value_and_grad_fn is not None:
                loss, grads = weighted_value_and_grad_fn(opt.params, coords, pixels[a],
                                                         weights[a])
            else:
                loss, grads = batched_autodiff_value_and_grad(apply_fn, opt.params, coords,
                                                              pixels[a], weights[a])
            loss, grads = _reduce(mesh, scale, loss, grads)
            opt.step(grads, valid[:, a])
            total += torch.where(valid_t[:, a], loss, zero)
        losses[step] = total / n_valid
        if step >= total_steps - seg:
            with torch.no_grad():
                acc1 += apply_fn(opt.params, eval_coords_1x)
                acc2 += apply_fn(opt.params, eval_coords_scale)
    pred_1x, pred_scale = acc1 / seg, acc2 / seg
    if scale is not None:
        pred_1x = _mesh_ops().all_gather_cat(pred_1x, mesh, "data", dim=1)
        pred_scale = _mesh_ops().all_gather_cat(pred_scale, mesh, "data", dim=1)
    return EnsembleResult(opt.params, losses, pred_1x, pred_scale)


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
              value_grad_absmax_fn: Callable | None = None, mesh=None) -> FitUntilResult:
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
    Each step copies its loss and max |out| to the host once.

    With ``mesh``, ``coords`` and ``target`` are this rank's shards: the
    loss and grads are summed over the data row and max |out| is its max,
    before the read-back, so every rank stops and restarts at the same
    step; each draw of ``init_fn`` is broadcast from the first rank of the
    data row, so the replicas start equal even where ``init_fn`` draws from
    a generator of each rank's own."""
    scale = _data_scale(mesh, coords.device, coords=coords.shape[0])

    def draw(k: int) -> list:
        params = init_fn(k)
        if scale is not None:
            _mesh_ops().broadcast_from_first(params, mesh, "data")
        return params

    params = draw(0)
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
        if scale is not None:
            loss_t, grads = _reduce(mesh, scale, loss_t, grads)
            absmax_t = _mesh_ops().all_reduce_max(absmax_t, mesh, "data")
        opt.step(grads)
        loss, absmax = torch.stack([loss_t, absmax_t]).tolist()
        losses.append(loss)
        it += 1
        if absmax == 0.0:
            restarts.append(it)
            params = draw(len(restarts))
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
    mesh=None,
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
    ``ff_coords`` or ``mean_target``.

    With ``mesh``, ``ff_coords``, ``mean_target`` and ``acq_pixels`` (its
    P axis) are this rank's shards: a mean step's K1 call and a PN step's
    forward and backward (K3 and K2 through ``inr_apply``) run on the local
    rows, and their loss and grads are reduced before each step; the loss
    trace is the global one on every rank."""
    scale = _data_scale(mesh, ff_coords.device, ff_coords=ff_coords.shape[0])
    inr_params, pn_params = inr_opt.params, pn_opt.params
    losses = torch.empty(num_epochs, dtype=torch.float32, device=ff_coords.device)

    @span("fit.inr_step")
    def inr_step():
        if inr_value_and_grad is not None:
            loss, grads = inr_value_and_grad(inr_params, ff_coords, mean_target)
        else:
            loss, grads = autodiff_value_and_grad(inr_apply, inr_params, ff_coords,
                                                  mean_target)
        loss, grads = _reduce(mesh, scale, loss, grads)
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
            with span("fit.pn_step"):
                with torch.enable_grad():
                    leaves = [p.detach().requires_grad_() for p in pn_params]
                    perturbed = pn_apply(leaves, ff_coords, float(a), pn_eps)
                    enc = (fourier_encode(perturbed, B) if pn_encode is None
                           else pn_encode(perturbed))
                    loss = mse(inr_apply(inr_frozen, enc), acq_pixels[a])
                    grads = torch.autograd.grad(loss, leaves)
                loss, grads = _reduce(mesh, scale, loss.detach(), grads)
                pn_opt.step(grads)
            total += loss
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


@span("infer.request")
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
    with span("infer.grid"):
        sizes_t = torch.tensor(sizes, dtype=torch.int64, device=device)
        strides = torch.tensor([math.prod(sizes[a + 1:]) for a in range(len(sizes))],
                               dtype=torch.int64, device=device)
        denom = torch.clamp(sizes_t - 1, min=1).to(torch.float32)
    outs = []
    for start in range(0, P, chunk):
        with span("infer.chunk"):
            with span("infer.coords"):
                i = torch.arange(start, min(start + chunk, P), dtype=torch.int64, device=device)
                idx = (i[:, None] // strides[None, :]) % sizes_t[None, :]
                c = -1.0 + 2.0 * idx.to(torch.float32) / denom
            with span("infer.encode"):
                x = fourier_encode(c, fourier_B)
            out = apply_fn(params, x)
            outs.append(out if clamp_min is None else out.clamp_min(clamp_min))
    with span("infer.gather"):
        out = torch.cat(outs, dim=0)
    with span("infer.to_host"):
        return out.cpu().numpy()
