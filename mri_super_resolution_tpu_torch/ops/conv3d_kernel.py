"""RAMS convolution kernel K6: the wrapper over the hand-written CUDA kernel
of ``csrc/conv3d.cu`` and its plain PyTorch version.

Counterpart of ``conv3d_rfab`` in
``mri_super_resolution_tpu/ops/pallas/conv3d_kernel.py``: a 3x3x3
convolution plus bias on channels-last ``(B, H, W, T, C)`` activations,
SAME or VALID, kernel ``(3, 3, 3, C, Cout)`` in spatial order (H, W, T), C
and Cout multiples of 8. The compute type is ``x``'s: bfloat16 operands
(the kernel is rounded to bfloat16) or float32, float32 sums, the float32
bias added last, one rounding to ``x.dtype``, as the TPU kernel does with
``compute_dtype=bfloat16`` and ``None``.

A wrapper given CPU tensors runs the plain version
(:func:`conv3d_rfab_ref`); given CUDA tensors it launches the kernel or
raises, and adds one to :data:`LAUNCHES`. The backward (K7) is not ported:
on the card the wrapper refuses inputs that need a gradient.
"""
from __future__ import annotations

import ctypes

import torch

from mri_super_resolution_tpu_torch.ops import _build

# one count per wrapper, bumped once per kernel launch on a CUDA tensor
LAUNCHES: dict[str, int] = {"conv3d_rfab": 0}

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


def _check(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
           padding: str) -> str:
    """The device type of a valid call (``kernel`` already in ``x.dtype``,
    ``bias`` in float32); raises on anything the kernel does not take."""
    if x.dim() != 5:
        raise ValueError(f"x must be (B, H, W, T, C); got shape {tuple(x.shape)}")
    B, H, W, T, C = x.shape
    if kernel.dim() != 5 or tuple(kernel.shape[:4]) != (3, 3, 3, C):
        raise ValueError(f"kernel must be (3, 3, 3, {C}, Cout); got {tuple(kernel.shape)}")
    Cout = kernel.shape[4]
    if C % 8 or Cout % 8:
        raise ValueError(f"C ({C}) and Cout ({Cout}) must be multiples of 8")
    if tuple(bias.shape) != (Cout,):
        raise ValueError(f"bias must be ({Cout},); got {tuple(bias.shape)}")
    _, Ho, Wo, To = out_shape(x.shape, padding)
    if min(Ho, Wo, To) < 1:
        raise ValueError(f"VALID needs H, W, T >= 3; got {(H, W, T)}")
    if B > MAX_GRID_YZ or To > MAX_GRID_YZ:
        raise ValueError(f"B ({B}) and T_out ({To}) must be at most {MAX_GRID_YZ}")
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


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.conv3d_rfab_f32, lib.conv3d_rfab_bf16):
        fn.argtypes = [p, i, i, i, i, i, p, p, i, i, p, p]
        fn.restype = i


def _lib() -> ctypes.CDLL:
    return _build.library("conv3d", _declare)


def _launch(lib, x, kernel, bias, padding, stream) -> torch.Tensor:
    B, H, W, T, C = x.shape
    Cout = kernel.shape[4]
    out = torch.empty(*out_shape(x.shape, padding), Cout, dtype=x.dtype, device=x.device)
    for t in (x, out):
        if t.data_ptr() % 16:
            raise ValueError("conv3d_rfab takes 16-byte aligned x and out")
    fn = lib.conv3d_rfab_bf16 if x.dtype == torch.bfloat16 else lib.conv3d_rfab_f32
    rc = fn(x.data_ptr(), B, H, W, T, C, kernel.data_ptr(), bias.data_ptr(), Cout,
            1 if padding == "SAME" else 0, out.data_ptr(), stream)
    _build.raise_on(rc, "conv3d_rfab")
    return out


def conv3d_rfab(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                padding: str = "SAME") -> torch.Tensor:
    """K6: ``conv3d(x, kernel) + bias`` in ``x.dtype``, shape ``(B, Ho, Wo,
    To, Cout)``. ``kernel`` is rounded to ``x.dtype`` and ``bias`` taken in
    float32 first, as the TPU kernel casts them."""
    kernel = kernel.to(x.dtype)
    bias = bias.float()
    if _check(x, kernel, bias, padding) == "cpu":
        return conv3d_rfab_ref(x, kernel, bias, padding)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, kernel, bias)):
        raise NotImplementedError(
            "conv3d_rfab has no backward on the card yet (K7 conv3d_rfab_bwd is ROADMAP "
            "Queue 2); call it under torch.no_grad() or torch.inference_mode()")
    out = _launch(_lib(), x, kernel.detach(), bias.detach(), padding, _build.stream_ptr())
    LAUNCHES["conv3d_rfab"] += 1
    return out
