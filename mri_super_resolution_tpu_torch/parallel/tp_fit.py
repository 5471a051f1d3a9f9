"""Tensor-parallel SIREN fit: the hidden width sharded over a ``model`` axis.

Counterpart of ``mri_super_resolution_tpu/parallel/tp_fit.py``, Megatron's
alternating column- and row-parallel layers. GSPMD inserted the collectives
in the JAX package; here they are two autograd functions:

- layer 0 and every even sine layer are column-parallel: each rank holds a
  slice of the output features (rows of the ``(out, in)`` weight, and of
  the bias); the input enters through *f* (identity forward, ``all_reduce``
  of the gradient backward over the model group), and ``sin`` passes the
  feature shard straight on;
- every odd sine layer is row-parallel: each rank holds a slice of the
  input features (columns of the weight); its partial product leaves
  through *g* (``all_reduce`` forward, identity backward) before the
  replicated bias is added: one collective per pair of layers;
- the head is row-parallel when the sine stack has odd length (its input
  is then feature-sharded), else replicated.

With a ``data`` axis too, the voxel batch shards over it and every
gradient (sharded leaves included: they are replicated over ``data``) is
averaged over the data group. Adam's moments live with their shards.

This is correctness-first, as in the JAX package: at the production widths
one card running K1 is faster; two ranks sharing one card measure
correctness, not scaling.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from mri_super_resolution_tpu_torch.models.siren import Siren
from mri_super_resolution_tpu_torch.parallel.mesh import (
    Mesh, Spec, all_gather_cat, all_reduce_sum, local_slice, mesh_2d, shard_batch)
from mri_super_resolution_tpu_torch.parallel.sharded_fit import ShardedFitResult


def make_tp_mesh(data: int = 1, model: int | None = None, ranks: Sequence[int] | None = None
                 ) -> Mesh:
    """A (data, model) mesh over ``ranks`` (default every rank);
    ``model=None`` uses every remaining rank."""
    return mesh_2d(("data", "model"), data, model, ranks)


def siren_tp_specs(model, model_axis: str = "model") -> list[Spec]:
    """The shard spec of each tensor of ``model.weights()`` (W is ``(out,
    in)``): column-parallel sine layers shard W's rows and the bias,
    row-parallel ones W's columns, and the head follows the stack's parity.
    Raises for anything but a plain :class:`Siren` (the ERD and toy variants
    carry perturbation branches and ReLU heads)."""
    if not isinstance(model, Siren) or getattr(model, "perturb", None) is not None:
        raise ValueError("siren_tp_specs supports plain Siren models (sine layers + one "
                         f"final linear); got {type(model).__name__}")
    n_sine = len(model.net) - 1
    specs: list[Spec] = []
    for i in range(n_sine):
        if i % 2 == 0:
            specs += [Spec(model_axis, None), Spec(model_axis)]
        else:
            specs += [Spec(None, model_axis), Spec()]
    # the head's input is feature-sharded iff the last sine layer was
    # column-parallel, i.e. the stack length is odd
    specs += [Spec(None, model_axis) if n_sine % 2 else Spec(), Spec()]
    return specs


def _check_divisible(params: Sequence[torch.Tensor], specs: Sequence[Spec], mesh: Mesh) -> None:
    for i, (p, spec) in enumerate(zip(params, specs)):
        for dim, ax in enumerate(spec):
            if ax is not None and p.shape[dim] % mesh.axis_size(ax):
                raise ValueError(f"param {i} dim {dim} ({p.shape[dim]}) not divisible by "
                                 f"mesh axis '{ax}' ({mesh.axis_size(ax)})")


def shard_params(params: Sequence[torch.Tensor], specs: Sequence[Spec], mesh: Mesh) -> list:
    """This rank's shard of each param (copies)."""
    return [shard_batch(p, mesh, spec).clone(memory_format=torch.contiguous_format)
            for p, spec in zip(params, specs)]


def gather_params(shards: Sequence[torch.Tensor], specs: Sequence[Spec], mesh: Mesh) -> list:
    """The full params from every rank's shards (every rank gets them)."""
    out = []
    for s, spec in zip(shards, specs):
        for dim, ax in enumerate(spec):
            if ax is not None:
                s = all_gather_cat(s, mesh, ax, dim=dim)
        out.append(s)
    return out


class _CopyToModel(torch.autograd.Function):
    """*f*: identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """*g*: the partial products summed over the model group; identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_siren_apply(shards: Sequence[torch.Tensor], x: torch.Tensor, omegas: Sequence[float],
                   group) -> torch.Tensor:
    """The Siren forward on this rank's weight shards (``siren_tp_specs``
    layout); ``group`` is the model group (``None``: one rank, no
    collective)."""
    f = (lambda t: t) if group is None else (lambda t: _CopyToModel.apply(t, group))
    g = (lambda t: t) if group is None else (lambda t: _ReduceFromModel.apply(t, group))
    n_sine = len(shards) // 2 - 1
    h = x
    for i in range(n_sine):
        W, b = shards[2 * i], shards[2 * i + 1]
        if i % 2 == 0:
            z = f(h) @ W.T + b
        else:
            z = g(h @ W.T) + b
        h = torch.sin(omegas[i] * z)
    W, b = shards[-2], shards[-1]
    return (g(h @ W.T) if n_sine % 2 else h @ W.T) + b


def make_tp_fit(model: Siren, opt_fn: Callable, mesh: Mesh, num_steps: int,
                param_specs: Sequence[Spec]):
    """A tensor-parallel (and data-parallel over ``data``) full-batch fit:
    ``fit(params, coords, target) -> ShardedFitResult``. ``params`` are the
    full ``model.weights()``-ordered tensors, ``coords``/``target`` the
    whole batch; each rank takes its shards, and the result holds the full
    trained params (gathered) and the per-step losses."""
    omegas = model.omegas
    group = mesh.group("model")
    data = mesh.axis_size("data")

    def run(params: Sequence[torch.Tensor], coords: torch.Tensor,
            target: torch.Tensor) -> ShardedFitResult:
        _check_divisible(params, param_specs, mesh)
        opt = opt_fn(shard_params([p.detach() for p in params], param_specs, mesh))
        x = coords[local_slice(coords.shape[0], mesh, "data")]
        t = target[local_slice(target.shape[0], mesh, "data")]
        losses = torch.empty(num_steps, dtype=torch.float32, device=coords.device)
        for i in range(num_steps):
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_() for p in opt.params]
                r = tp_siren_apply(leaves, x, omegas, group) - t
                loss = (r * r).mean() / data
                grads = torch.autograd.grad(loss, leaves)
            loss, *grads = all_reduce_sum([loss.detach(), *grads], mesh, "data")
            opt.step(grads)
            losses[i] = loss
        return ShardedFitResult(gather_params(opt.params, param_specs, mesh), losses)

    return run
