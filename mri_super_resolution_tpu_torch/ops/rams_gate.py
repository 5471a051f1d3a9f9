"""The RFAB channel-attention gate at inference (G1): the wrapper over the
hand-written CUDA kernels of ``csrc/rams_gate.cu``, its plain PyTorch
version, and the rule that routes a gate to it.

``models/rams.py``'s RFAB ends in ``att = sigmoid(att1(relu(att0(mean(
float(x)))))).to(x.dtype)`` and ``x * att + res`` on channels-last ``(B, H,
W, T, C)`` activations. :func:`rfab_gate` computes the same on the ``(B, S,
C)`` view in three launches (the pooled sums in fixed slots, the gate MLP
per item, one fused product and add) instead of PyTorch's cast, mean, a
dozen tiny launches, product and add. It replaces no TPU kernel: the JAX
package leaves the gate to XLA. Given the same ``att`` its output equals
the eager chain's bit for bit; ``att`` itself may differ from the eager
one's in the last bits (another order of the mean's sums, fmaf in the
MLP).

:func:`fused_applies` says whether an RFAB takes it: a CUDA tensor with
grad off (``predict_case`` and ``misr.run`` run under
``torch.inference_mode``), outside a ``torch.export`` trace (a graph cannot
hold the ctypes calls). There the wrapper launches the kernels or raises
(:func:`refusal` names why); everything else, training with grad on, every
CPU run and an export, keeps the eager chain (``RFAB.gate_eager``).
:data:`LAUNCHES` counts the gates by path: ``rfab_gate`` (this wrapper) and
``rfab_gate_eager`` (bumped by ``RFAB.gate_eager``). The wrapper is a span
of ``utils/profiling.py`` (``kernel.rfab_gate``), and its ctypes calls
``kernel.launch`` spans.
"""
from __future__ import annotations

import ctypes

import torch

from mri_super_resolution_tpu_torch.ops import _build
from mri_super_resolution_tpu_torch.utils.profiling import span

# gates by path: the fused kernels on the card, the eager chain anywhere
LAUNCHES: dict[str, int] = {"rfab_gate": 0, "rfab_gate_eager": 0}

DTYPES = (torch.bfloat16, torch.float32)
MAX_CHANNELS = 256  # csrc/rams_gate.cu: one thread a channel in the gate pass
MAX_ITEMS = 65535  # the item index is gridDim.y
# pixels a slot of the sum pass: 38 slots an item at the serving shape
# (130 x 130 x 9), 950 blocks over its 25 items, one wave on 132 SMs
SLOT_PIXELS = 4096
_INT_MAX = 2 ** 31 - 1
_THREADS = 256  # csrc/rams_gate.cu's NT


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def refusal(x: torch.Tensor, res: torch.Tensor) -> str | None:
    """Why the kernels do not take the gate of ``x`` with residual ``res``,
    or None when they do."""
    if x.dtype not in DTYPES or res.dtype != x.dtype:
        return f"x and res must share bfloat16 or float32; got {x.dtype} and {res.dtype}"
    if x.dim() < 3 or res.shape != x.shape:
        return (f"x and res must be one (B, ..., C) shape; got {tuple(x.shape)} and "
                f"{tuple(res.shape)}")
    if res.device != x.device:
        return f"x and res must share a device; got {x.device} and {res.device}"
    if not (x.is_contiguous() and res.is_contiguous()):
        return "x and res must be contiguous (channels last)"
    B, C = x.shape[0], x.shape[-1]
    S = x.numel() // max(B * C, 1)
    if not 1 <= C <= MAX_CHANNELS:
        return f"C must be 1 to {MAX_CHANNELS}; got {C}"
    if (not 1 <= B <= MAX_ITEMS or S < 1 or S * C + _THREADS >= _INT_MAX
            or S + SLOT_PIXELS + 4 * _THREADS >= _INT_MAX):
        return f"(B, S) = ({B}, {S}) outside the kernels' grid"
    if not x.is_cuda:
        return f"G1 runs on the card; got {x.device} tensors (the eager gate serves the CPU)"
    return None


def fused_applies(x: torch.Tensor) -> bool:
    """Whether an RFAB's gate runs :func:`rfab_gate`: on the card with grad
    off, and not inside a ``torch.export`` (or ``torch.compile``) trace."""
    return x.is_cuda and not torch.is_grad_enabled() and not torch.compiler.is_compiling()


def _weights(C: int, w0, b0, w1, b1, device) -> None:
    R = w0.shape[-1]
    for name, t, shape in (("w0", w0, (C, R)), ("b0", b0, (R,)), ("w1", w1, (R, C)),
                           ("b1", b1, (C,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {shape}; got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"all tensors must be on {device}; got {name} on {t.device}")
    if not 1 <= R <= C:
        raise ValueError(f"the gate's hidden width must be 1 to C ({C}); got {R}")


def rfab_gate_ref(x: torch.Tensor, res: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                  w1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """Plain G1: the pooled mean of ``x`` over every axis but the first and
    the last in float32, ``att = sigmoid(relu(mean @ w0 + b0) @ w1 + b1)``
    rounded to ``x.dtype``, then ``x * att + res`` in ``x.dtype``."""
    B, C = x.shape[0], x.shape[-1]
    m = x.reshape(B, -1, C).float().mean(dim=1)
    att = torch.sigmoid(torch.relu(m @ w0 + b0) @ w1 + b1).to(x.dtype)
    return x * att.reshape(B, *(1,) * (x.dim() - 2), C) + res


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.rams_gate_att_bf16, lib.rams_gate_att_f32):
        fn.argtypes = [p, i, i, i, p, p, i, p, p, i, p, p, p]
        fn.restype = i
    for fn in (lib.rams_gate_apply_bf16, lib.rams_gate_apply_f32):
        fn.argtypes = [p, p, p, i, i, i, p, p]
        fn.restype = i


def _lib() -> ctypes.CDLL:
    return _build.library("rams_gate", _declare)


def work_floats(B: int, S: int, C: int, slot_pixels: int = SLOT_PIXELS) -> int:
    """Floats of the workspace of a call, the slots' sums: ``B
    ceil(S / slot_pixels) C``."""
    return B * -(-S // slot_pixels) * C


def _launch_att(lib, x, w0, b0, w1, b1, work, att, slot_pixels, stream) -> None:
    """The sum and gate passes on ``x`` (B, S, C): ``att`` (B, C) in
    ``x.dtype``; ``work`` as :func:`work_floats` sizes it for
    ``slot_pixels``."""
    B, S, C = x.shape
    fn = lib.rams_gate_att_bf16 if x.dtype == torch.bfloat16 else lib.rams_gate_att_f32
    with span("kernel.launch"):
        rc = fn(x.data_ptr(), B, S, C, w0.data_ptr(), b0.data_ptr(), w0.shape[1],
                w1.data_ptr(), b1.data_ptr(), slot_pixels, work.data_ptr(), att.data_ptr(),
                stream)
    _build.raise_on(rc, "rams_gate_att")


def _launch_apply(lib, x, att, res, out, stream) -> None:
    """The apply pass: ``out = x * att + res`` on (B, S, C), ``att`` (B, C)."""
    B, S, C = x.shape
    fn = lib.rams_gate_apply_bf16 if x.dtype == torch.bfloat16 else lib.rams_gate_apply_f32
    with span("kernel.launch"):
        rc = fn(x.data_ptr(), att.data_ptr(), res.data_ptr(), B, S, C, out.data_ptr(), stream)
    _build.raise_on(rc, "rams_gate_apply")


@span("kernel.rfab_gate")
def rfab_gate(x: torch.Tensor, res: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
              w1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """G1: ``x * sigmoid(relu(mean(x) @ w0 + b0) @ w1 + b1) + res`` in
    ``x.dtype``, the mean over every axis but the first and the last; ``w0``
    (C, R), ``b0`` (R,), ``w1`` (R, C), ``b1`` (C,) float32. CUDA tensors
    only: it launches the kernels, and the count moves, or raises. It has no
    backward: with grad on it refuses inputs that need a gradient."""
    reason = refusal(x, res)
    if reason is not None:
        raise ValueError(f"rfab_gate: {reason}")
    _weights(x.shape[-1], w0, b0, w1, b1, x.device)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, res, w0, b0, w1, b1)):
        raise ValueError("rfab_gate has no backward; the eager gate serves training")
    B, C = x.shape[0], x.shape[-1]
    x3, r3 = x.reshape(B, -1, C), res.reshape(B, -1, C)
    work = torch.empty(work_floats(B, x3.shape[1], C), dtype=torch.float32, device=x.device)
    att = torch.empty(B, C, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    lib, stream = _lib(), _build.stream_ptr()
    _launch_att(lib, x3, w0, b0, w1, b1, work, att, SLOT_PIXELS, stream)
    _launch_apply(lib, x3, att, r3, out.view(B, -1, C), stream)
    LAUNCHES["rfab_gate"] += 1
    return out
