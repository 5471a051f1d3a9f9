"""SIREN kernels K1-K3: wrappers over the hand-written CUDA kernels of
``csrc/siren.cu`` and their plain PyTorch versions.

Counterpart of ``mri_super_resolution_tpu/ops/pallas/siren_kernel.py``:

- :func:`siren_forward` (K3) <- ``siren_forward`` (fused MLP forward);
- :func:`siren_loss_grads` (K1) <- ``siren_loss_grads`` (one-pass forward,
  masked MSE and backward: loss and weight gradients);
- :func:`siren_fused_bwd` (K2) <- the ``_bwd`` of ``siren_fused`` (recompute
  the forward, backprop an upstream gradient: dx and, when asked, dW/db);
- :func:`siren_fused` <- ``siren_fused``: K3 forward with K2 as its backward,
  as a ``torch.autograd.Function``.

Weights are a flat list ``[W0, b0, ..., W_last, b_last]`` in torch
``nn.Linear`` layout: ``W_l`` is (out, in). Every layer but the last is a
sine layer ``sin(omega_l * (h W_l^T + b_l))``; the last is linear with one
output. ``omega`` is one float for every sine layer or one per sine layer.

A wrapper given CPU tensors runs the plain version (``*_ref``); given CUDA
tensors it launches the kernel or raises, and adds one to its entry of
:data:`LAUNCHES`. The plain versions run on either device and are what the
CPU tests and ``chip_smoke.py`` hold the kernels against.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from mri_super_resolution_tpu_torch.ops import _build

# one count per wrapper, bumped once per kernel launch on a CUDA tensor
LAUNCHES: dict[str, int] = {"siren_forward": 0, "siren_loss_grads": 0,
                            "siren_fused_bwd": 0}



def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# contract checks
# --------------------------------------------------------------------------


def _layer_dims(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> list[int]:
    if len(weights) % 2 or len(weights) < 4:
        raise ValueError("weights must be [W0, b0, ..., W_last, b_last] with at "
                         f"least one sine layer; got {len(weights)} tensors")
    if x.dim() != 2:
        raise ValueError(f"x must be (P, d_in); got shape {tuple(x.shape)}")
    dims = [int(x.shape[1])]
    for l in range(len(weights) // 2):
        W, b = weights[2 * l], weights[2 * l + 1]
        if W.dim() != 2 or W.shape[1] != dims[-1] or b.shape != (W.shape[0],):
            raise ValueError(
                f"layer {l}: W {tuple(W.shape)} / b {tuple(b.shape)} do not "
                f"continue width {dims[-1]} (W is (out, in), b is (out,))")
        dims.append(int(W.shape[0]))
    if dims[-1] != 1:
        raise ValueError(f"the last layer must have one output; got {dims[-1]}")
    return dims


def _omegas(omega: float | Sequence[float], n_sine: int) -> list[float]:
    if isinstance(omega, (int, float)):
        return [float(omega)] * n_sine
    omegas = [float(o) for o in omega]
    if len(omegas) != n_sine:
        raise ValueError(f"{len(omegas)} omegas for {n_sine} sine layers")
    return omegas


def _check(x: torch.Tensor, weights: Sequence[torch.Tensor], *others) -> str:
    return _build.check_tensors("SIREN", x, [*weights, *others], (torch.float32,))


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def siren_forward_ref(x: torch.Tensor, weights: Sequence[torch.Tensor],
                      omega: float | Sequence[float] = 30.0) -> torch.Tensor:
    """Plain K3: the MLP forward with torch ops (differentiable)."""
    n = len(weights) // 2
    omegas = _omegas(omega, n - 1)
    h = x
    for l in range(n - 1):
        h = torch.sin(omegas[l] * (h @ weights[2 * l].T + weights[2 * l + 1]))
    return h @ weights[-2].T + weights[-1]


def _stash_forward(x, weights, omegas):
    """Forward through the sine layers, keeping each layer's input and its
    factor omega * cos(omega z)."""
    inputs, factors = [x], []
    h = x
    for l in range(len(weights) // 2 - 1):
        z = omegas[l] * (h @ weights[2 * l].T + weights[2 * l + 1])
        h = torch.sin(z)
        factors.append(omegas[l] * torch.cos(z))
        inputs.append(h)
    return inputs, factors


def _backprop(weights, inputs, factors, delta, need_dw: bool, need_dx: bool):
    """Backward chain from delta = dL/dz of the last layer."""
    n = len(weights) // 2
    grads = [None] * len(weights)
    dx = None
    for l in reversed(range(n)):
        if need_dw:
            grads[2 * l] = delta.T @ inputs[l]
            grads[2 * l + 1] = delta.sum(0)
        if l > 0:
            delta = (delta @ weights[2 * l]) * factors[l - 1]
        elif need_dx:
            dx = delta @ weights[0]
    return dx, (grads if need_dw else None)


@torch.no_grad()
def siren_loss_grads_ref(x, weights, target, omega=30.0, n_rows=None):
    """Plain K1: ``(loss, grads)`` of the MSE over the first ``n_rows`` rows
    (default all), normalised by ``n_rows * out_dim`` as the TPU kernel does;
    rows at and beyond ``n_rows`` contribute nothing."""
    P = x.shape[0]
    n_rows = P if n_rows is None else int(n_rows)
    inv_n = 1.0 / (n_rows * target.shape[-1])
    omegas = _omegas(omega, len(weights) // 2 - 1)
    inputs, factors = _stash_forward(x, weights, omegas)
    out = inputs[-1] @ weights[-2].T + weights[-1]
    rows = torch.arange(P, device=x.device)[:, None]
    r = torch.where(rows < n_rows, out - target, torch.zeros_like(out))
    loss = (r * r).sum() * inv_n
    _, grads = _backprop(weights, inputs, factors, (2.0 * inv_n) * r, True, False)
    return loss, grads


@torch.no_grad()
def siren_fused_bwd_ref(x, weights, g, omega=30.0, need_dw=True, need_dx=True):
    """Plain K2: ``(dx, grads)`` for the upstream gradient ``g`` (P, 1);
    ``None`` in place of what was not asked for."""
    omegas = _omegas(omega, len(weights) // 2 - 1)
    inputs, factors = _stash_forward(x, weights, omegas)
    return _backprop(weights, inputs, factors, g, need_dw, need_dx)


# --------------------------------------------------------------------------
# CUDA launches
# --------------------------------------------------------------------------


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.siren_partial_floats.argtypes = [i, p, i]
    lib.siren_partial_floats.restype = ctypes.c_longlong
    lib.siren_forward_f32.argtypes = [p, i, p, i, p, p, p, p, p, p, p]
    lib.siren_forward_f32.restype = i
    lib.siren_loss_grads_f32.argtypes = [p, i, i, p, i, p, p, p, p, f, p, p, p, p, p,
                                         p, p, p, p]
    lib.siren_loss_grads_f32.restype = i
    lib.siren_fused_bwd_f32.argtypes = [p, i, p, i, p, p, p, p, p, p, p, p, p, p, p, p,
                                        p]
    lib.siren_fused_bwd_f32.restype = i


def _lib() -> ctypes.CDLL:
    return _build.library("siren", _declare)


class _Args:
    """ctypes views of the shared arguments; keeps the arrays alive."""

    def __init__(self, x, weights, omega):
        self.dims_list = _layer_dims(x, weights)
        self.n_layers = len(weights) // 2
        self.dims = (ctypes.c_int * len(self.dims_list))(*self.dims_list)
        self.W = _build.ptr_array(weights[0::2])
        self.b = _build.ptr_array(weights[1::2])
        omegas = _omegas(omega, self.n_layers - 1)
        self.omegas = (ctypes.c_float * len(omegas))(*omegas)
        self.P = int(x.shape[0])
        self.width = max(self.dims_list[1:-1])


def _stash_buffers(a: _Args, like: torch.Tensor):
    P = a.P
    acts = [torch.empty(P, d, dtype=like.dtype, device=like.device)
            for d in a.dims_list[1:-1]]
    facts = [torch.empty_like(t) for t in acts]
    delta0 = torch.empty(P, a.width, dtype=like.dtype, device=like.device)
    delta1 = torch.empty_like(delta0)
    return acts, facts, delta0, delta1


def _partial(lib, a: _Args, like: torch.Tensor) -> torch.Tensor:
    n = lib.siren_partial_floats(a.P, ctypes.cast(a.dims, ctypes.c_void_p), a.n_layers)
    return torch.empty(int(n), dtype=like.dtype, device=like.device)


def _launch_forward(lib, x, weights, omega, stream) -> torch.Tensor:
    a = _Args(x, weights, omega)
    out = torch.empty(a.P, 1, dtype=x.dtype, device=x.device)
    buf0 = torch.empty(a.P, a.width, dtype=x.dtype, device=x.device)
    buf1 = torch.empty_like(buf0)
    rc = lib.siren_forward_f32(
        x.data_ptr(), a.P, ctypes.cast(a.dims, ctypes.c_void_p), a.n_layers,
        a.W, a.b,
        ctypes.cast(a.omegas, ctypes.c_void_p), out.data_ptr(), buf0.data_ptr(),
        buf1.data_ptr(), stream)
    _build.raise_on(rc, "siren_forward")
    return out


def _launch_loss_grads(lib, x, weights, target, omega, n_rows, stream):
    a = _Args(x, weights, omega)
    inv_n = 1.0 / (n_rows * target.shape[-1])
    acts, facts, delta0, delta1 = _stash_buffers(a, x)
    partial = _partial(lib, a, x)
    grads = [torch.empty_like(w) for w in weights]
    loss = torch.empty((), dtype=x.dtype, device=x.device)
    rc = lib.siren_loss_grads_f32(
        x.data_ptr(), a.P, int(n_rows), ctypes.cast(a.dims, ctypes.c_void_p),
        a.n_layers, a.W,
        a.b, ctypes.cast(a.omegas, ctypes.c_void_p),
        target.data_ptr(), inv_n, _build.ptr_array(acts),
        _build.ptr_array(facts), delta0.data_ptr(),
        delta1.data_ptr(), partial.data_ptr(),
        _build.ptr_array(grads[0::2]),
        _build.ptr_array(grads[1::2]), loss.data_ptr(), stream)
    _build.raise_on(rc, "siren_loss_grads")
    return loss, grads


def _launch_fused_bwd(lib, x, weights, g, omega, need_dw, need_dx, stream):
    a = _Args(x, weights, omega)
    acts, facts, delta0, delta1 = _stash_buffers(a, x)
    partial = _partial(lib, a, x)
    grads = [torch.empty_like(w) for w in weights] if need_dw else None
    dx = torch.empty_like(x) if need_dx else None
    dW = _build.ptr_array(grads[0::2]) if need_dw else None
    db = _build.ptr_array(grads[1::2]) if need_dw else None
    rc = lib.siren_fused_bwd_f32(
        x.data_ptr(), a.P, ctypes.cast(a.dims, ctypes.c_void_p), a.n_layers,
        a.W, a.b,
        ctypes.cast(a.omegas, ctypes.c_void_p), g.data_ptr(),
        _build.ptr_array(acts),
        _build.ptr_array(facts), delta0.data_ptr(),
        delta1.data_ptr(), partial.data_ptr(), dW, db,
        None if dx is None else dx.data_ptr(), stream)
    _build.raise_on(rc, "siren_fused_bwd")
    return dx, grads


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def siren_forward(x: torch.Tensor, weights: Sequence[torch.Tensor],
                  omega: float | Sequence[float] = 30.0) -> torch.Tensor:
    """K3: the MLP output (P, 1)."""
    weights = list(weights)
    _layer_dims(x, weights)
    if _check(x, weights) == "cpu":
        return siren_forward_ref(x, weights, omega)
    out = _launch_forward(_lib(), x, [w.detach() for w in weights], omega,
                          _build.stream_ptr())
    LAUNCHES["siren_forward"] += 1
    return out


def siren_loss_grads(x: torch.Tensor, weights: Sequence[torch.Tensor],
                     target: torch.Tensor, omega: float | Sequence[float] = 30.0,
                     n_rows: int | None = None):
    """K1: ``(loss, grads)`` of ``mean((MLP(x) - target)^2)`` over the first
    ``n_rows`` rows (default all), with ``grads`` matching ``weights``."""
    weights = list(weights)
    _layer_dims(x, weights)
    if target.shape != (x.shape[0], 1):
        raise ValueError(f"target must be ({x.shape[0]}, 1); got {tuple(target.shape)}")
    n_rows = x.shape[0] if n_rows is None else int(n_rows)
    if not 0 < n_rows <= x.shape[0]:
        raise ValueError(f"n_rows {n_rows} outside (0, {x.shape[0]}]")
    if _check(x, weights, target) == "cpu":
        return siren_loss_grads_ref(x, weights, target, omega, n_rows)
    out = _launch_loss_grads(_lib(), x, [w.detach() for w in weights], target, omega,
                             n_rows, _build.stream_ptr())
    LAUNCHES["siren_loss_grads"] += 1
    return out


def siren_fused_bwd(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    g: torch.Tensor, omega: float | Sequence[float] = 30.0,
                    need_dw: bool = True, need_dx: bool = True):
    """K2: ``(dx, grads)`` for the upstream gradient ``g`` (P, 1) of the MLP
    output; ``None`` in place of what was not asked for."""
    weights = list(weights)
    _layer_dims(x, weights)
    if g.shape != (x.shape[0], 1):
        raise ValueError(f"g must be ({x.shape[0]}, 1); got {tuple(g.shape)}")
    if _check(x, weights, g) == "cpu":
        return siren_fused_bwd_ref(x, weights, g, omega, need_dw, need_dx)
    out = _launch_fused_bwd(_lib(), x, [w.detach() for w in weights], g, omega,
                            need_dw, need_dx, _build.stream_ptr())
    LAUNCHES["siren_fused_bwd"] += 1
    return out


class _SirenFused(torch.autograd.Function):
    """K3 forward; K2 backward (dx always when asked, dW/db only when some
    weight requires grad)."""

    @staticmethod
    def forward(ctx, x, omega, *weights):
        ctx.omega = omega
        ctx.save_for_backward(x, *weights)
        return siren_forward(x, weights, omega)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        need_dw = any(ctx.needs_input_grad[2:])
        dx, grads = siren_fused_bwd(x, weights, g.contiguous(), ctx.omega,
                                    need_dw=need_dw, need_dx=need_dx)
        return (dx, None, *(grads if need_dw else [None] * len(weights)))


def siren_fused(x: torch.Tensor, weights: Sequence[torch.Tensor],
                omega: float | Sequence[float] = 30.0) -> torch.Tensor:
    """Differentiable MLP forward: K3 forward, K2 backward."""
    omega = omega if isinstance(omega, (int, float)) else tuple(omega)
    return _SirenFused.apply(x, omega, *weights)
