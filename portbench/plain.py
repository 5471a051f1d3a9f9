"""Plain float32 PyTorch pieces of the configurations' references: the
SIREN and PerturbNet forwards, Fourier features, the dense [-1, 1] grid,
optax's Adam, and the precision switch of the control.

Written from the published models (implicit-neural-representations'
``Siren``, ``PerturbNet`` and ``optax.adam``), not from the port: nothing
here imports the program or JAX. Products are float32 with TF32 off, unless
:func:`precision` says otherwise.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def precision(name: str):
    """``"float32"``: true float32 products (TF32 off); ``"tf32"``: the
    control, TF32 products on the card (the nearest precision below the
    configurations' float32). Restores the previous setting."""
    if name not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {name!r}")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def grid(shape, device) -> torch.Tensor:
    """The (prod(shape), len(shape)) float32 grid: ``linspace(-1, 1, n)`` on
    each axis, the last axis fastest."""
    axes = [np.linspace(-1.0, 1.0, int(n)) for n in shape]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, len(shape))
    return torch.as_tensor(pts.astype(np.float32), device=device)


def fourier(x: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``[sin(2 pi x B^T), cos(2 pi x B^T)]``."""
    proj = (2.0 * math.pi * x) @ B.T
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def siren(params, x: torch.Tensor, omega: float) -> torch.Tensor:
    """``sin(omega (W h + b))`` on every layer but the last, which is
    linear. ``params``: ``[W0, b0, ..., W_last, b_last]``, W (out, in)."""
    h = x
    n = len(params) // 2
    for layer in range(n):
        z = h @ params[2 * layer].T + params[2 * layer + 1]
        h = torch.sin(omega * z) if layer < n - 1 else z
    return h


def perturbnet(params, x: torch.Tensor, acq: int, eps: float, acq_scale: float = 10.0):
    """``eps tanh(L1(tanh(L0([x, acq / acq_scale]))))``."""
    col = torch.full((x.shape[0], 1), float(acq), dtype=x.dtype, device=x.device) / acq_scale
    h = torch.tanh(torch.cat([x, col], dim=1) @ params[0].T + params[1])
    return eps * torch.tanh(h @ params[2].T + params[3])


def loss_and_grads(fn, params, weights=None):
    """``(loss, grads)`` of ``loss = fn(leaves)`` by autograd."""
    leaves = [p.detach().clone().requires_grad_() for p in params]
    with torch.enable_grad():
        loss = fn(leaves)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), [g.detach() for g in grads]


class Adam:
    """optax.adam (b1 0.9, b2 0.999, eps 1e-8) on a list of tensors."""

    def __init__(self, params, lr: float):
        self.params = [p.detach().clone() for p in params]
        self.lr = float(lr)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        self.count += 1
        c1, c2 = 1.0 - B1 ** self.count, 1.0 - B2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.copy_(B1 * m + (1.0 - B1) * g)
            v.copy_(B2 * v + (1.0 - B2) * g * g)
            p.copy_(p - self.lr * (m / c1) / (torch.sqrt(v / c2) + EPS))
