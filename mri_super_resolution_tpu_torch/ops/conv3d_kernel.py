"""RAMS convolution kernels K6 (forward) and K7 (backward): the wrappers over
the hand-written CUDA kernels of ``csrc/conv3d.cu``, their plain PyTorch
versions, and the trainable ``torch.autograd.Function`` that pairs them.

Counterparts of ``conv3d_rfab``, ``conv3d_rfab_bwd`` and
``conv3d_rfab_trainable`` in
``mri_super_resolution_tpu/ops/pallas/conv3d_kernel.py``: a 3x3x3
convolution plus bias on channels-last ``(B, H, W, T, C)`` activations,
SAME or VALID, kernel ``(3, 3, 3, C, Cout)`` in spatial order (H, W, T), C
and Cout multiples of 8. The compute type is ``x``'s: bfloat16 operands
(the kernel is rounded to bfloat16) or float32, float32 sums, the float32
bias added last, one rounding to ``x.dtype``, as the TPU kernel does with
``compute_dtype=bfloat16`` and ``None``. The backward takes its operands in
``x.dtype`` too (the kernel rounded, the cotangent cast), sums in float32,
rounds dx once to ``x.dtype`` and returns dW and db in float32.

A wrapper given CPU tensors runs the plain version (:func:`conv3d_rfab_ref`,
:func:`conv3d_rfab_bwd_ref`); given CUDA tensors it launches the kernel or
raises, and adds one to its count in :data:`LAUNCHES`. On the card,
:func:`conv3d_rfab` hands inputs that need a gradient to
:func:`conv3d_rfab_trainable`, so their backward runs K7.
"""
from __future__ import annotations

import ctypes

import torch

from mri_super_resolution_tpu_torch.ops import _build

# one count per wrapper, bumped once per kernel launch on a CUDA tensor
LAUNCHES: dict[str, int] = {"conv3d_rfab": 0, "conv3d_rfab_bwd": 0}

DTYPES = (torch.bfloat16, torch.float32)
MAX_GRID_YZ = 65535  # the kernel puts t_out on gridDim.y and the batch on gridDim.z
TAPS = [(dy, dx, dz) for dy in range(3) for dx in range(3) for dz in range(3)]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def out_shape(x_shape, padding: str) -> tuple[int, int, int, int]:
    """``(B, Ho, Wo, To)`` of the convolution of an ``x_shape`` input."""
    B, H, W, T = x_shape[:4]
    if padding == "SAME":
        return B, H, W, T
    if padding == "VALID":
        return B, H - 2, W - 2, T - 2
    raise ValueError(f"padding must be 'SAME' or 'VALID'; got {padding!r}")


def _check(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None,
           padding: str) -> str:
    """The device type of a valid call (``kernel`` already in ``x.dtype``,
    ``bias`` in float32, or None for the backward); raises on anything the
    kernels do not take."""
    if x.dim() != 5:
        raise ValueError(f"x must be (B, H, W, T, C); got shape {tuple(x.shape)}")
    B, H, W, T, C = x.shape
    if kernel.dim() != 5 or tuple(kernel.shape[:4]) != (3, 3, 3, C):
        raise ValueError(f"kernel must be (3, 3, 3, {C}, Cout); got {tuple(kernel.shape)}")
    Cout = kernel.shape[4]
    if C % 8 or Cout % 8:
        raise ValueError(f"C ({C}) and Cout ({Cout}) must be multiples of 8")
    _, Ho, Wo, To = out_shape(x.shape, padding)
    if min(Ho, Wo, To) < 1:
        raise ValueError(f"VALID needs H, W, T >= 3; got {(H, W, T)}")
    # t_out (at most T, which K7's dx produces) on gridDim.y, the batch on z
    if B > MAX_GRID_YZ or T > MAX_GRID_YZ:
        raise ValueError(f"B ({B}) and T ({T}) must be at most {MAX_GRID_YZ}")
    if bias is not None:
        if tuple(bias.shape) != (Cout,):
            raise ValueError(f"bias must be ({Cout},); got {tuple(bias.shape)}")
        _build.check_tensors("conv3d_rfab", bias, [], (torch.float32,))
        if bias.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}; got bias on {bias.device}")
    return _build.check_tensors("conv3d_rfab", x, [kernel], DTYPES)


def conv3d_rfab_ref(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                    padding: str = "SAME") -> torch.Tensor:
    """Plain K6: the same contract tap by tap. Operands in ``x.dtype``
    (the kernel rounded to it), 27 products of shifted ``(N, C) @ (C,
    Cout)`` slices summed in float32, the float32 bias added, one rounding
    to ``x.dtype``. Never forms the ``(N, 27 C)`` operand."""
    B, Ho, Wo, To = out_shape(x.shape, padding)
    C, Cout = kernel.shape[3], kernel.shape[4]
    xf = x.float()
    wf = kernel.to(x.dtype).float()
    if padding == "SAME":
        xf = torch.nn.functional.pad(xf, (0, 0, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros(B * Ho * Wo * To, Cout, dtype=torch.float32, device=x.device)
    for dy, dx, dz in TAPS:
        tap = xf[:, dy:dy + Ho, dx:dx + Wo, dz:dz + To, :].reshape(-1, C)
        acc.addmm_(tap, wf[dy, dx, dz])
    return (acc + bias.float()).to(x.dtype).reshape(B, Ho, Wo, To, Cout)


def conv3d_rfab_bwd_ref(x: torch.Tensor, kernel: torch.Tensor, g: torch.Tensor,
                        padding: str = "SAME"
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain K7, tap by tap: ``dW[tap] = x_tap^T g`` and ``dx[tap window]
    += g W[tap]^T`` in float32 from operands in ``x.dtype``, ``db = g.sum``
    in float32; dx rounded once to ``x.dtype`` (a SAME forward's padded
    border dropped). Never forms the ``(N, 27 C)`` operand."""
    B, Ho, Wo, To = out_shape(x.shape, padding)
    C, Cout = kernel.shape[3], kernel.shape[4]
    xf = x.float()
    wf = kernel.to(x.dtype).float()
    gf = g.to(x.dtype).float().reshape(-1, Cout)
    if padding == "SAME":
        xf = torch.nn.functional.pad(xf, (0, 0, 1, 1, 1, 1, 1, 1))
    dxp = torch.zeros_like(xf)
    dw = torch.empty(3, 3, 3, C, Cout, dtype=torch.float32, device=x.device)
    for dy, dx, dz in TAPS:
        tap = xf[:, dy:dy + Ho, dx:dx + Wo, dz:dz + To, :].reshape(-1, C)
        torch.mm(tap.t(), gf, out=dw[dy, dx, dz])
        dxp[:, dy:dy + Ho, dx:dx + Wo, dz:dz + To, :] += (
            gf @ wf[dy, dx, dz].t()).reshape(B, Ho, Wo, To, C)
    if padding == "SAME":
        dxp = dxp[:, 1:-1, 1:-1, 1:-1, :]
    return dxp.to(x.dtype), dw, gf.sum(0)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.conv3d_rfab_f32, lib.conv3d_rfab_bf16):
        fn.argtypes = [p, i, i, i, i, i, p, p, i, i, p, p]
        fn.restype = i
    for fn in (lib.conv3d_rfab_bwd_f32, lib.conv3d_rfab_bwd_bf16):
        fn.argtypes = [p, i, i, i, i, i, p, p, i, i, p, p, p, p, i, p]
        fn.restype = i
    lib.conv3d_rfab_bwd_slots.argtypes = [i, i, i, i, i]
    lib.conv3d_rfab_bwd_slots.restype = i


def _lib() -> ctypes.CDLL:
    return _build.library("conv3d", _declare)


def _aligned(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("conv3d_rfab kernels take 16-byte aligned activations")


def _launch(lib, x, kernel, bias, padding, stream) -> torch.Tensor:
    B, H, W, T, C = x.shape
    Cout = kernel.shape[4]
    out = torch.empty(*out_shape(x.shape, padding), Cout, dtype=x.dtype, device=x.device)
    _aligned(x, out)
    fn = lib.conv3d_rfab_bf16 if x.dtype == torch.bfloat16 else lib.conv3d_rfab_f32
    rc = fn(x.data_ptr(), B, H, W, T, C, kernel.data_ptr(), bias.data_ptr(), Cout,
            1 if padding == "SAME" else 0, out.data_ptr(), stream)
    _build.raise_on(rc, "conv3d_rfab")
    return out


def _launch_bwd(lib, x, kernel, g, padding, stream):
    B, H, W, T, C = x.shape
    Cout = kernel.shape[4]
    pad = 1 if padding == "SAME" else 0
    slots = lib.conv3d_rfab_bwd_slots(B, H, W, T, pad)
    work = torch.empty(slots * (27 * C * Cout + Cout), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dw = torch.empty(3, 3, 3, C, Cout, dtype=torch.float32, device=x.device)
    db = torch.empty(Cout, dtype=torch.float32, device=x.device)
    _aligned(x, g, dx, dw, db, work)
    fn = lib.conv3d_rfab_bwd_bf16 if x.dtype == torch.bfloat16 else lib.conv3d_rfab_bwd_f32
    rc = fn(x.data_ptr(), B, H, W, T, C, kernel.data_ptr(), g.data_ptr(), Cout, pad,
            dx.data_ptr(), dw.data_ptr(), db.data_ptr(), work.data_ptr(), slots, stream)
    _build.raise_on(rc, "conv3d_rfab_bwd")
    return dx, dw, db


def conv3d_rfab(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                padding: str = "SAME") -> torch.Tensor:
    """K6: ``conv3d(x, kernel) + bias`` in ``x.dtype``, shape ``(B, Ho, Wo,
    To, Cout)``. ``kernel`` is rounded to ``x.dtype`` and ``bias`` taken in
    float32 first, as the TPU kernel casts them. On CPU tensors the plain
    version runs (autograd goes through it); on the card, inputs that need
    a gradient go through :func:`conv3d_rfab_trainable`."""
    kernel_c = kernel.to(x.dtype)
    bias_f = bias.float()
    if _check(x, kernel_c, bias_f, padding) == "cpu":
        return conv3d_rfab_ref(x, kernel_c, bias_f, padding)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, kernel, bias)):
        return conv3d_rfab_trainable(x, kernel, bias, padding)
    out = _launch(_lib(), x, kernel_c.detach(), bias_f.detach(), padding, _build.stream_ptr())
    LAUNCHES["conv3d_rfab"] += 1
    return out


def conv3d_rfab_bwd(x: torch.Tensor, kernel: torch.Tensor, g: torch.Tensor,
                    padding: str = "SAME"
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7: the gradients ``(dx, dkernel, dbias)`` of :func:`conv3d_rfab` for
    the cotangent ``g`` of its ``(B, Ho, Wo, To, Cout)`` output. dx is in
    ``x.dtype``; dkernel ``(3, 3, 3, C, Cout)`` (dy, dx, dz order) and dbias
    ``(Cout,)`` are float32. ``kernel`` is rounded and ``g`` cast to
    ``x.dtype`` first."""
    kernel_c = kernel.detach().to(x.dtype)
    g = g.detach().to(x.dtype)
    device = _check(x, kernel_c, None, padding)
    want = (*out_shape(x.shape, padding), kernel_c.shape[4])
    if tuple(g.shape) != want:
        raise ValueError(f"g must be {want}; got {tuple(g.shape)}")
    _build.check_tensors("conv3d_rfab_bwd", x, [g], DTYPES)
    if device == "cpu":
        return conv3d_rfab_bwd_ref(x, kernel_c, g, padding)
    out = _launch_bwd(_lib(), x.detach(), kernel_c, g, padding, _build.stream_ptr())
    LAUNCHES["conv3d_rfab_bwd"] += 1
    return out


class _Trainable(torch.autograd.Function):
    """K6 forward, K7 backward (``_trainable_fwd`` / ``_trainable_bwd`` of
    the JAX package): the forward saves ``x`` and the kernel as given (float32
    in the RAMS), the backward returns dx in ``x.dtype`` and dkernel, dbias
    in the kernel's type."""

    @staticmethod
    def forward(ctx, x, kernel, bias, padding):
        ctx.padding = padding
        ctx.save_for_backward(x, kernel)
        return conv3d_rfab(x, kernel, bias, padding)  # grad mode is off in here

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        dx, dk, db = conv3d_rfab_bwd(x, kernel, g.contiguous(), ctx.padding)
        return dx, dk.to(kernel.dtype), db.to(kernel.dtype), None


def conv3d_rfab_trainable(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                          padding: str = "SAME") -> torch.Tensor:
    """:func:`conv3d_rfab` whose backward is K7 (its plain version on CPU
    tensors). Under ``torch.no_grad`` or ``inference_mode`` it is K6 alone."""
    return _Trainable.apply(x, kernel, bias, padding)
