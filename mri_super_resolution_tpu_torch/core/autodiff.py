"""Differential operators of INR outputs with respect to the input
coordinates.

Counterpart of ``mri_super_resolution_tpu/core/autodiff.py`` (``gradient``,
``divergence``, ``laplace`` :30-53; the reference's nn_mri.py:208-225 chains
``torch.autograd.grad`` with ``create_graph``). Built, as the JAX package
is, on per-point transforms: ``torch.func`` ``vmap`` over ``grad``,
``jacfwd`` and ``hessian`` of the function at a single point.

Every operator takes a pointwise function ``f(coords (M, d)) -> (M, 1)`` or
``(M,)`` (a module, or a closure over one; its parameters are constants
here) and returns per-point quantities on the coordinates' device.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, hessian, jacfwd, vmap


def _scalarize(f: Callable) -> Callable:
    def g(x: torch.Tensor) -> torch.Tensor:
        return f(x[None]).reshape(())  # one point through the network

    return g


def gradient(f: Callable, coords: torch.Tensor) -> torch.Tensor:
    """Per-point gradient of a scalar field: (N, d) -> (N, d)."""
    return vmap(grad(_scalarize(f)))(coords)


def divergence(vf: Callable, coords: torch.Tensor) -> torch.Tensor:
    """Per-point divergence of a vector field (N, d) -> (N,)."""

    def single(x):
        jac = jacfwd(lambda y: vf(y[None]).reshape(-1))(x)
        return torch.trace(jac)

    return vmap(single)(coords)


def laplace(f: Callable, coords: torch.Tensor) -> torch.Tensor:
    """Per-point Laplacian of a scalar field, the trace of its Hessian: (N,)."""

    def single(x):
        return torch.trace(hessian(_scalarize(f))(x))

    return vmap(single)(coords)
