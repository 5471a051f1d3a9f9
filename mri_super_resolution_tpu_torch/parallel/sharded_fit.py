"""Multi-rank INR fits: voxel-sharded gradients and the cohort fit.

Counterpart of ``mri_super_resolution_tpu/parallel/sharded_fit.py``:

1. **Voxel data parallelism** (axis ``data``): each rank holds its shard of
   the coordinate batch (``mesh.shard_batch``) and a replica of the params;
   it computes the loss and gradient of its shard, by autograd or by the
   one-pass kernel K1, the ranks of its data row sum them in one
   ``all_reduce``, and every rank takes the same Adam step.
2. **Cohort parallelism** (axis ``case``): independent per-patient fits,
   one batched program over a leading case axis; ranks along ``case`` fit
   different patients, ranks along ``data`` share each one's gradient.

Parameters are lists of tensors (``Siren.weights()`` order); ``opt_fn``
builds the optimizer that holds them (``lambda p: Adam(p, 1e-4)``, or
``restart_adam``), as ``tx.init`` does inside the JAX fits. The loops run
eagerly and never read a value back inside them: each step's loss goes into
a preallocated tensor on the device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from mri_super_resolution_tpu_torch.fit.engine import autodiff_value_and_grad
from mri_super_resolution_tpu_torch.parallel.mesh import Mesh, all_reduce_sum


class ShardedFitResult(NamedTuple):
    params: list
    losses: torch.Tensor


def _real_rows(n_rows: int, local: int, mesh: Mesh) -> int:
    """How many of this rank's ``local`` rows are real when the global
    batch holds ``n_rows`` real rows followed by padding (equal shards)."""
    start = mesh.index("data") * local
    return max(0, min(local, n_rows - start))


def make_sharded_fit(apply_fn: Callable | None, opt_fn: Callable, mesh: Mesh, num_steps: int,
                     value_and_grad_fn: Callable | None = None, n_rows: int | None = None,
                     weighted_value_and_grad_fn: Callable | None = None):
    """A data-parallel full-batch fit over ``mesh``:
    ``fit(params, coords, target) -> ShardedFitResult`` with ``coords`` and
    ``target`` this rank's shard of the voxel axis (``shard_batch``) and
    ``params`` the replicated params (left as they are; the result holds
    trained copies).

    Each step's loss and gradient are those of the whole batch. Without
    ``n_rows`` every shard has as many rows, and the mean over the data row
    of the shards' means is the global mean (the JAX ``pmean``). Routes:
    autograd through ``apply_fn(params, x)``; ``value_and_grad_fn(params,
    x, target) -> (loss, grads)`` (K1 through
    ``ops/siren_kernel.py:make_fused_value_and_grad``).

    ``n_rows``: the real row count when the batch was padded with
    ``pad_to_multiple`` so that it divides the mesh; the padding (coordinate
    0, target 0) leaves the loss and the gradient, and the loss is the MSE
    over the real rows. On autograd each rank differentiates its real rows'
    squared-error sum; with ``value_and_grad_fn``, which must take
    ``n_rows=`` (K1's adapter does), each rank calls it on its real rows
    alone and weighs the result by their count, so K1 keeps its unweighted
    tensor-core route (the padding sits at the end of the batch); a rank
    whose shard is all padding adds zeros and launches nothing. Either way
    the data row sums, and the step divides by ``n_rows``: the JAX
    package's ``mask * rescale`` numbers. ``weighted_value_and_grad_fn(params,
    x, target, w)``, the JAX package's route (a 0/1 row mask through K1's
    weighted variant), is taken too."""
    if sum(f is not None for f in (value_and_grad_fn, weighted_value_and_grad_fn)) > 1:
        raise ValueError("pass value_and_grad_fn or weighted_value_and_grad_fn, not both")
    if weighted_value_and_grad_fn is not None and n_rows is None:
        raise ValueError("weighted_value_and_grad_fn masks padded rows: it needs n_rows")
    data = mesh.axis_size("data")

    def local_terms(params, coords, target):
        """(loss, grads) of this shard, scaled so that their sum over the
        data row is the step's loss and gradient."""
        P_local = coords.shape[0]
        if n_rows is None:
            if value_and_grad_fn is not None:
                loss, grads = value_and_grad_fn(params, coords, target)
            else:
                loss, grads = autodiff_value_and_grad(apply_fn, params, coords, target)
            return loss / data, [g / data for g in grads]
        real = _real_rows(n_rows, P_local, mesh)
        if weighted_value_and_grad_fn is not None:
            w = torch.zeros_like(target)
            w[:real] = 1.0
            # the weighted mean is over the P_local rows of the shard
            loss, grads = weighted_value_and_grad_fn(params, coords, target, w)
            scale = P_local / n_rows
        elif real == 0:
            return (torch.zeros((), device=coords.device),
                    [torch.zeros_like(p) for p in params])
        elif value_and_grad_fn is not None:
            loss, grads = value_and_grad_fn(params, coords, target, n_rows=real)
            scale = real / n_rows
        else:
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_() for p in params]
                r = apply_fn(leaves, coords[:real]) - target[:real]
                loss = (r * r).sum() / n_rows
                grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), list(grads)
        return loss * scale, [g * scale for g in grads]

    def run(params: Sequence[torch.Tensor], coords: torch.Tensor,
            target: torch.Tensor) -> ShardedFitResult:
        opt = opt_fn([p.detach().clone() for p in params])
        losses = torch.empty(num_steps, dtype=torch.float32, device=coords.device)
        for i in range(num_steps):
            loss, grads = local_terms(opt.params, coords, target)
            loss, *grads = all_reduce_sum([loss, *grads], mesh, "data")
            opt.step(grads)
            losses[i] = loss
        return ShardedFitResult(opt.params, losses)

    return run


def stack_params(params_list: Sequence[Sequence[torch.Tensor]]) -> list[torch.Tensor]:
    """Per-case parameter lists stacked along a new leading case axis."""
    return [torch.stack(list(xs)) for xs in zip(*params_list)]


def make_cohort_fit(apply_fn: Callable, opt_fn: Callable, mesh: Mesh, num_steps: int):
    """A cohort fit: ``fit(params_stack, coords, targets) ->
    ShardedFitResult`` with this rank's shards, ``params_stack`` leading
    with its cases (``shard_batch(..., Spec("case"))``), ``coords`` (C, P,
    d) and ``targets`` (C, P, 1) sharded ``Spec("case", "data")``.

    Every case trains independently: one program runs ``apply_fn`` of each
    case under ``torch.func.vmap``, autograd of the sum of the cases' mean
    squared errors gives each case its own gradient, and Adam is elementwise,
    so one optimizer over the stacks is the cases' optimizers side by side
    (the same step count for every case: they step together). Ranks along
    ``data`` average each case's loss and gradient. The result holds this
    rank's cases: ``losses`` (C_local, num_steps)."""
    data = mesh.axis_size("data")
    batched = torch.func.vmap(apply_fn)

    def run(params_stack: Sequence[torch.Tensor], coords: torch.Tensor,
            targets: torch.Tensor) -> ShardedFitResult:
        opt = opt_fn([p.detach().clone() for p in params_stack])
        C = coords.shape[0]
        losses = torch.empty(C, num_steps, dtype=torch.float32, device=coords.device)
        for i in range(num_steps):
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_() for p in opt.params]
                r = batched(leaves, coords) - targets
                per_case = (r * r).mean(dim=(1, 2)) / data
                grads = torch.autograd.grad(per_case.sum(), leaves)
            per_case, *grads = all_reduce_sum([per_case.detach(), *grads], mesh, "data")
            opt.step(grads)
            losses[:, i] = per_case
        return ShardedFitResult(opt.params, losses)

    return run
