"""WIRE kernels K4-K5: wrappers over the hand-written CUDA kernels of
``csrc/wire.cu`` and ``csrc/wire_tc.cu`` and their plain PyTorch versions.

Counterpart of ``mri_super_resolution_tpu/ops/pallas/wire_kernel.py``:

- :func:`wire_forward` (K5) <- ``wire_forward`` (fused Gabor forward);
- :func:`wire_loss_grads` (K4) <- ``wire_loss_grads`` (one-pass forward,
  masked MSE and hand-derived backward: loss and the gradient of every
  weight; omega/sigma are read, not differentiated);
- :func:`make_wire_fused_apply` / :func:`make_wire_value_and_grad` <- the
  JAX package's wrappers of the same names, over :meth:`Wire.params` lists.

``weights`` is the flat list of :meth:`Wire.weights` (torch (out, in)
layout); ``omegas`` is the ``(n_layers, 2)`` tensor of [omega, sigma] per
layer, on the same device, read by the kernels on the device. The kernels'
contract is the single exponential ``m = exp(-omega si - sigma^2 (|s|^2 +
|s2|^2))`` of the JAX kernel (its plain versions here use it too), which
cannot overflow where the model's ``exp(-omega si)`` factor alone can.

A wrapper given CPU tensors runs the plain version (``*_ref``); given CUDA
tensors it launches the kernel or raises, and adds one to its entry of
:data:`LAUNCHES`. The TPU kernel's VMEM gate (``wire_kernel_fits``) has no
counterpart: the CUDA kernels take any width.

The route, chosen from the shapes alone (:func:`wire_tc_route`): a K4 or
K5 call with a hidden width H that is a multiple of 64
(:data:`WIRE_TC_STEP`) and at least one hidden layer (the reference's 4 ->
256x2 -> 1) runs on the tensor cores (``csrc/wire_tc.cu``: bf16x3 split
products, float32 accumulation, the Gabor activation and its backward fused
into the products' epilogues) under the ``wire_loss_grads_tc`` and
``wire_forward_tc`` keys (K5 runs K4's forward passes alone); every other
call on the SIMT kernels of ``csrc/wire.cu``. The route is not a fallback:
a tensor-core launch that fails raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from mri_super_resolution_tpu_torch.models.wire import FINAL_N, FIRST_N, HIDDEN_N, n_weights
from mri_super_resolution_tpu_torch.ops import _build

# one count per wrapper, bumped once per kernel launch on a CUDA tensor
LAUNCHES: dict[str, int] = {"wire_forward": 0, "wire_loss_grads": 0, "wire_loss_grads_tc": 0,
                            "wire_forward_tc": 0}

WIRE_TC_STEP = 64  # csrc/wire_tc.cu: H a multiple of it, so 2H and 4H fill 128-wide tiles


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# contract checks
# --------------------------------------------------------------------------


def _shapes(x: torch.Tensor, weights: Sequence[torch.Tensor],
            omegas: torch.Tensor) -> tuple[int, int, int]:
    """(d_in, H, n_hidden) of a valid call; raises on anything else."""
    nw = len(weights)
    if nw < FIRST_N + FINAL_N or (nw - FIRST_N - FINAL_N) % HIDDEN_N:
        raise ValueError(f"{nw} weights do not make a WIRE network (4 + 8 n_hidden + 3)")
    n_hidden = (nw - FIRST_N - FINAL_N) // HIDDEN_N
    if x.dim() != 2:
        raise ValueError(f"x must be (P, d_in); got shape {tuple(x.shape)}")
    d, H = int(x.shape[1]), int(weights[0].shape[0])
    want = [(H, d), (H,), (H, d), (H,)]
    want += [(H, H), (H, H), (H,), (H,), (H, H), (H, H), (H,), (H,)] * n_hidden
    want += [(1, H), (1, H), (1,)]
    for i, (w, shape) in enumerate(zip(weights, want)):
        if tuple(w.shape) != shape:
            raise ValueError(f"weight {i} has shape {tuple(w.shape)}, expected {shape} "
                             f"(d_in {d}, width {H}, {n_hidden} hidden layers)")
    if tuple(omegas.shape) != (n_hidden + 1, 2):
        raise ValueError(f"omegas must be ({n_hidden + 1}, 2); got {tuple(omegas.shape)}")
    return d, H, n_hidden


def _check(x: torch.Tensor, weights: Sequence[torch.Tensor], *others) -> str:
    return _build.check_tensors("WIRE", x, [*weights, *others], (torch.float32,))


def wire_tc_route(H: int, n_hidden: int) -> bool:
    """Whether a K4 or K5 call on the card runs on the tensor-core route: a hidden
    width that is a multiple of :data:`WIRE_TC_STEP` and at least one hidden
    layer (whose block products the route runs on the tensor cores)."""
    return H > 0 and H % WIRE_TC_STEP == 0 and n_hidden >= 1


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _gabor(sr, si, s2r, s2i, om, sg):
    """(m, sin, cos) of the kernels' single-exponential Gabor activation."""
    if si is None:
        u = -(sg * sg) * (sr * sr + s2r * s2r)
    else:
        u = -om * si - (sg * sg) * (sr * sr + si * si + s2r * s2r + s2i * s2i)
    z = om * sr
    return torch.exp(u), torch.sin(z), torch.cos(z)


def _forward(x, weights, omegas, n_hidden, stash: bool):
    """The network's output and, when ``stash``, each Gabor layer's inputs
    (hr, hi) and pre-activations (sr, si, s2r, s2i)."""
    w = weights
    sr = x @ w[0].T + w[1]
    s2r = x @ w[2].T + w[3]
    m, sn, cs = _gabor(sr, None, s2r, None, omegas[0, 0], omegas[0, 1])
    saved = [((x, None), (sr, None, s2r, None))] if stash else []
    hr, hi = m * cs, m * sn
    for l in range(n_hidden):
        k = w[FIRST_N + HIDDEN_N * l:FIRST_N + HIDDEN_N * (l + 1)]
        sr = hr @ k[0].T - hi @ k[1].T + k[2]
        si = hr @ k[1].T + hi @ k[0].T + k[3]
        s2r = hr @ k[4].T - hi @ k[5].T + k[6]
        s2i = hr @ k[5].T + hi @ k[4].T + k[7]
        if stash:
            saved.append(((hr, hi), (sr, si, s2r, s2i)))
        m, sn, cs = _gabor(sr, si, s2r, s2i, omegas[l + 1, 0], omegas[l + 1, 1])
        hr, hi = m * cs, m * sn
    f = w[len(w) - FINAL_N:]
    out = hr @ f[0].T - hi @ f[1].T + f[2]
    return out, saved, (hr, hi)


def wire_forward_ref(x: torch.Tensor, weights: Sequence[torch.Tensor],
                     omegas: torch.Tensor) -> torch.Tensor:
    """Plain K5: the network's output (P, 1) with torch ops."""
    n_hidden = (len(weights) - FIRST_N - FINAL_N) // HIDDEN_N
    return _forward(x, list(weights), omegas, n_hidden, stash=False)[0]


@torch.no_grad()
def wire_loss_grads_ref(x, weights, omegas, target, n_rows=None):
    """Plain K4: ``(loss, grads)`` of the MSE over the first ``n_rows`` rows
    (default all), normalised by ``n_rows``; rows at and beyond ``n_rows``
    contribute nothing. The backward is the JAX kernel's hand derivation
    (``wire_kernel.py:225-289`` of the JAX package)."""
    weights = list(weights)
    P = x.shape[0]
    n_rows = P if n_rows is None else int(n_rows)
    inv_n = 1.0 / (n_rows * target.shape[-1])
    n_hidden = (len(weights) - FIRST_N - FINAL_N) // HIDDEN_N
    out, saved, (hr, hi) = _forward(x, weights, omegas, n_hidden, stash=True)
    rows = torch.arange(P, device=x.device)[:, None]
    r = torch.where(rows < n_rows, out - target, torch.zeros_like(out))
    loss = (r * r).sum() * inv_n
    g = (2.0 * inv_n) * r
    grads: list = [None] * len(weights)

    base = len(weights) - FINAL_N
    grads[base] = g.T @ hr
    grads[base + 1] = -(g.T @ hi)
    grads[base + 2] = g.sum(0)
    dhr, dhi = g @ weights[base], -(g @ weights[base + 1])
    for l in reversed(range(n_hidden + 1)):
        (hr, hi), (sr, si, s2r, s2i) = saved[l]
        om, sg2 = omegas[l, 0], omegas[l, 1] * omegas[l, 1]
        m, sn, cs = _gabor(sr, si, s2r, s2i, om, omegas[l, 1])
        du = (dhr * cs + dhi * sn) * m
        dsr = du * (-2.0 * sg2 * sr) + om * m * (dhi * cs - dhr * sn)
        ds2r = du * (-2.0 * sg2 * s2r)
        if l == 0:
            grads[0], grads[1] = dsr.T @ x, dsr.sum(0)
            grads[2], grads[3] = ds2r.T @ x, ds2r.sum(0)
            break
        dsi = du * (-om - 2.0 * sg2 * si)
        ds2i = du * (-2.0 * sg2 * s2i)
        b = FIRST_N + HIDDEN_N * (l - 1)
        k = weights[b:b + HIDDEN_N]
        grads[b] = dsr.T @ hr + dsi.T @ hi
        grads[b + 1] = dsi.T @ hr - dsr.T @ hi
        grads[b + 2], grads[b + 3] = dsr.sum(0), dsi.sum(0)
        grads[b + 4] = ds2r.T @ hr + ds2i.T @ hi
        grads[b + 5] = ds2i.T @ hr - ds2r.T @ hi
        grads[b + 6], grads[b + 7] = ds2r.sum(0), ds2i.sum(0)
        dhr = dsr @ k[0] + dsi @ k[1] + ds2r @ k[4] + ds2i @ k[5]
        dhi = -(dsr @ k[1]) + dsi @ k[0] - ds2r @ k[5] + ds2i @ k[4]
    return loss, grads


# --------------------------------------------------------------------------
# CUDA launches
# --------------------------------------------------------------------------


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wire_pack_floats.argtypes = [i, i, i]
    lib.wire_pack_floats.restype = ctypes.c_longlong
    lib.wire_work_floats.argtypes = [i, i, i, i]
    lib.wire_work_floats.restype = ctypes.c_longlong
    lib.wire_forward_f32.argtypes = [p, i, i, i, i, p, p, p, p, p, p, p, p]
    lib.wire_forward_f32.restype = i
    lib.wire_loss_grads_f32.argtypes = [p, i, i, i, i, i, p, p, p, f, p, p, p, p, p, p,
                                        p, p, p]
    lib.wire_loss_grads_f32.restype = i


def _lib() -> ctypes.CDLL:
    return _build.library("wire", _declare)


def _tc_declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wire_tc_workspace_bytes.argtypes = [i, i, i, i]
    lib.wire_tc_workspace_bytes.restype = ctypes.c_longlong
    lib.wire_loss_grads_tc.argtypes = [p, i, i, i, i, i, p, p, p, f, p, p, p, p]
    lib.wire_loss_grads_tc.restype = i
    lib.wire_forward_tc_workspace_bytes.argtypes = [i, i, i, i]
    lib.wire_forward_tc_workspace_bytes.restype = ctypes.c_longlong
    lib.wire_forward_tc.argtypes = [p, i, i, i, i, p, p, p, p, p]
    lib.wire_forward_tc.restype = i


def _tc_lib() -> ctypes.CDLL:
    return _build.library("wire_tc", _tc_declare)


def _launch_forward(lib, x, weights, omegas, stream) -> torch.Tensor:
    d, H, nh = _shapes(x, weights, omegas)
    P = int(x.shape[0])
    new = lambda *shape: torch.empty(*shape, dtype=x.dtype, device=x.device)
    out = new(P, 1)
    packed = new(int(lib.wire_pack_floats(d, H, nh)))
    S = new(P, (4 if nh else 2) * H)
    buf0, buf1 = new(P, 2 * H), new(P, 2 * H)
    rc = lib.wire_forward_f32(
        x.data_ptr(), P, d, H, nh, _build.ptr_array(weights), omegas.data_ptr(),
        out.data_ptr(), packed.data_ptr(), S.data_ptr(), buf0.data_ptr(),
        buf1.data_ptr(), stream)
    _build.raise_on(rc, "wire_forward")
    return out


def _launch_forward_tc(lib, x, weights, omegas, stream) -> torch.Tensor:
    """K5 on the tensor-core route (the shapes :func:`wire_tc_route` takes)."""
    d, H, nh = _shapes(x, weights, omegas)
    P = int(x.shape[0])
    nbytes = int(lib.wire_forward_tc_workspace_bytes(P, d, H, nh))
    if nbytes < 0:
        raise ValueError(f"the tensor-core K5 does not take width {H} with {nh} hidden layers")
    work = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    out = torch.empty(P, 1, dtype=x.dtype, device=x.device)
    rc = lib.wire_forward_tc(x.data_ptr(), P, d, H, nh, _build.ptr_array(weights),
                             omegas.data_ptr(), work.data_ptr(), out.data_ptr(), stream)
    _build.raise_on(rc, "wire_forward_tc")
    return out


def _launch_loss_grads(lib, x, weights, omegas, target, n_rows, stream):
    d, H, nh = _shapes(x, weights, omegas)
    P = int(x.shape[0])
    inv_n = 1.0 / (n_rows * target.shape[-1])
    new = lambda *shape: torch.empty(*shape, dtype=x.dtype, device=x.device)
    packed = new(int(lib.wire_pack_floats(d, H, nh)))
    work = new(int(lib.wire_work_floats(P, d, H, nh)))
    S = [new(P, 2 * H)] + [new(P, 4 * H) for _ in range(nh)]
    A = [new(P, 2 * H) for _ in range(nh + 1)]
    dS = new(P, (4 if nh else 2) * H)
    dH = new(P, 2 * H) if nh else None
    grads = [torch.empty_like(w) for w in weights]
    loss = new(())
    rc = lib.wire_loss_grads_f32(
        x.data_ptr(), P, int(n_rows), d, H, nh, _build.ptr_array(weights),
        omegas.data_ptr(), target.data_ptr(), inv_n, packed.data_ptr(),
        _build.ptr_array(S), _build.ptr_array(A), dS.data_ptr(),
        None if dH is None else dH.data_ptr(), work.data_ptr(),
        _build.ptr_array(grads), loss.data_ptr(), stream)
    _build.raise_on(rc, "wire_loss_grads")
    return loss, grads


def _launch_loss_grads_tc(lib, x, weights, omegas, target, n_rows, stream):
    """K4 on the tensor-core route (the shapes :func:`wire_tc_route` takes)."""
    d, H, nh = _shapes(x, weights, omegas)
    P = int(x.shape[0])
    nbytes = int(lib.wire_tc_workspace_bytes(P, d, H, nh))
    if nbytes < 0:
        raise ValueError(f"the tensor-core K4 does not take width {H} with {nh} hidden layers")
    work = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    grads = [torch.empty_like(w) for w in weights]
    loss = torch.empty((), dtype=x.dtype, device=x.device)
    rc = lib.wire_loss_grads_tc(
        x.data_ptr(), P, int(n_rows), d, H, nh, _build.ptr_array(weights), omegas.data_ptr(),
        target.data_ptr(), 1.0 / (n_rows * target.shape[-1]), work.data_ptr(),
        _build.ptr_array(grads), loss.data_ptr(), stream)
    _build.raise_on(rc, "wire_loss_grads_tc")
    return loss, grads


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def wire_forward(x: torch.Tensor, weights: Sequence[torch.Tensor],
                 omegas: torch.Tensor) -> torch.Tensor:
    """K5: the WIRE output (P, 1)."""
    weights = list(weights)
    _, H, n_hidden = _shapes(x, weights, omegas)
    if _check(x, weights, omegas) == "cpu":
        return wire_forward_ref(x, weights, omegas)
    tc = wire_tc_route(H, n_hidden)
    launch = _launch_forward_tc if tc else _launch_forward
    out = launch(_tc_lib() if tc else _lib(), x, [w.detach() for w in weights],
                 omegas.detach(), _build.stream_ptr())
    LAUNCHES["wire_forward_tc" if tc else "wire_forward"] += 1
    return out


def wire_loss_grads(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    omegas: torch.Tensor, target: torch.Tensor,
                    n_rows: int | None = None):
    """K4: ``(loss, grads)`` of ``mean((WIRE(x) - target)^2)`` over the first
    ``n_rows`` rows (default all), with ``grads`` matching ``weights``."""
    weights = list(weights)
    _, H, n_hidden = _shapes(x, weights, omegas)
    if target.shape != (x.shape[0], 1):
        raise ValueError(f"target must be ({x.shape[0]}, 1); got {tuple(target.shape)}")
    n_rows = x.shape[0] if n_rows is None else int(n_rows)
    if not 0 < n_rows <= x.shape[0]:
        raise ValueError(f"n_rows {n_rows} outside (0, {x.shape[0]}]")
    if _check(x, weights, omegas, target) == "cpu":
        return wire_loss_grads_ref(x, weights, omegas, target, n_rows)
    tc = wire_tc_route(H, n_hidden)
    launch = _launch_loss_grads_tc if tc else _launch_loss_grads
    out = launch(_tc_lib() if tc else _lib(), x, [w.detach() for w in weights],
                 omegas.detach(), target, n_rows, _build.stream_ptr())
    LAUNCHES["wire_loss_grads_tc" if tc else "wire_loss_grads"] += 1
    return out


def split_params(params: Sequence[torch.Tensor], n_hidden: int):
    """:meth:`Wire.params` -> ``(weights, scales, omegas)``: the kernels'
    weight list, the omega/sigma parameters, and those as the kernels'
    ``(n_layers, 2)`` tensor (detached, on their device)."""
    nw = n_weights(n_hidden)
    weights, scales = list(params[:nw]), list(params[nw:])
    if len(scales) != 2 * (n_hidden + 1):
        raise ValueError(f"{len(params)} params do not fit {n_hidden} hidden layers")
    omegas = torch.cat([s.detach().reshape(1) for s in scales]).view(n_hidden + 1, 2)
    return weights, scales, omegas


def make_wire_fused_apply(n_hidden: int):
    """``apply(params, x)`` on K5 for :meth:`Wire.params` lists: the
    inference forward (no gradient), reading omega/sigma from the params, so
    it serves trainable configurations too."""

    def apply(params, x):
        weights, _, omegas = split_params(params, n_hidden)
        return wire_forward(x, weights, omegas)

    return apply


def make_wire_value_and_grad(n_hidden: int):
    """``value_and_grad(params, x, target) -> (loss, grads)`` on K4 for
    :meth:`Wire.params` lists; omega/sigma get zero gradients (the
    non-trainable configuration: Adam then leaves them as they are)."""

    def value_and_grad(params, x, target):
        weights, scales, omegas = split_params(params, n_hidden)
        loss, grads = wire_loss_grads(x, weights, omegas, target)
        return loss, grads + [torch.zeros_like(s) for s in scales]

    return value_and_grad
