"""Tensor-core rate probe P1: the wrapper over ``csrc/mma_probe.cu`` and its
plain PyTorch version.

Counterpart of the Pallas kernel of ``scripts/int8_mxu_probe.py`` (``build``
:56-64): ``grid_steps`` steps, each the sum over ``reps`` of the products
``A_r @ B`` of the (T, H) slices of ``a`` (reps T, H) with ``b`` (H, N),
added in float32 into one (T, N) output. bf16 operands sum in float32;
int8 operands sum exactly (int32) within a step, and the step's sum is
converted to float32 before it is added.

:func:`mma_probe` given CPU tensors runs :func:`mma_probe_ref`; given CUDA
tensors it launches the kernel or raises, and adds one to its entry of
:data:`LAUNCHES`. The kernel (``wgmma`` with both operands in shared memory)
takes T and N multiples of 128 and H a multiple of 128 up to 512 (bf16) or
of 256 up to 1024 (int8): one 128-column block of B stays in shared memory.
"""
from __future__ import annotations

import ctypes

import torch

from mri_super_resolution_tpu_torch.ops import _build

LAUNCHES: dict[str, int] = {"mma_probe_bf16": 0, "mma_probe_int8": 0}

DTYPES = {torch.bfloat16: "bf16", torch.int8: "int8"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _shapes(a: torch.Tensor, b: torch.Tensor, reps: int) -> tuple[int, int, int]:
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"the probe takes bf16 or int8 operands of one type; got "
                        f"{a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a must be (reps T, H) and b (H, N); got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if reps < 1 or a.shape[0] % reps:
        raise ValueError(f"{a.shape[0]} rows of a are not {reps} slices")
    return a.shape[0] // reps, int(a.shape[1]), int(b.shape[1])


@torch.no_grad()
def mma_probe_step_ref(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """One step: sum over r of ``a_r @ b``, float32 (T, N). int8 in float64,
    exact (a step's sum is at most H 127^2 reps, far below 2^53), then
    rounded once to float32; bf16 as float32 products (exact) summed in
    float32."""
    T, _, _ = _shapes(a, b, reps)
    exact = a.dtype == torch.int8
    wide = torch.float64 if exact else torch.float32
    bw = b.to(wide)
    acc = torch.zeros(T, b.shape[1], dtype=wide, device=a.device)
    for r in range(reps):
        acc += a[r * T:(r + 1) * T].to(wide) @ bw
    return acc.to(torch.float32)


@torch.no_grad()
def mma_probe_ref(a: torch.Tensor, b: torch.Tensor, reps: int,
                  grid_steps: int) -> torch.Tensor:
    """Plain P1: the step's sum added ``grid_steps`` times into a float32
    output in order, as the TPU grid adds it. The step is computed once:
    every step sums the same products."""
    step = mma_probe_step_ref(a, b, reps)
    out = torch.zeros_like(step)
    for _ in range(grid_steps):
        out += step
    return out


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mma_probe_splits.argtypes = [i, i, i]
    lib.mma_probe_splits.restype = i
    for fn in (lib.mma_probe_bf16, lib.mma_probe_s8):
        fn.argtypes = [p, p, i, i, i, i, i, i, p, p, p]
        fn.restype = i


def _lib() -> ctypes.CDLL:
    return _build.library("mma_probe", _declare)


def _launch(lib, a, bt, reps, grid_steps, stream, splits=None) -> torch.Tensor:
    """``bt`` is B transposed, (N, H) contiguous; ``splits`` (default: the
    kernel's plan) blocks share each output tile's steps."""
    T, H = a.shape[0] // reps, a.shape[1]
    N = bt.shape[0]
    splits = lib.mma_probe_splits(T, N, grid_steps) if splits is None else int(splits)
    partial = torch.empty(splits * T * N, dtype=torch.float32, device=a.device)
    out = torch.empty(T, N, dtype=torch.float32, device=a.device)
    fn = lib.mma_probe_s8 if a.dtype == torch.int8 else lib.mma_probe_bf16
    rc = fn(a.data_ptr(), bt.data_ptr(), T, N, H, reps, grid_steps, splits,
            partial.data_ptr(), out.data_ptr(), stream)
    _build.raise_on(rc, "mma_probe")
    return out


def mma_probe(a: torch.Tensor, b: torch.Tensor, reps: int, grid_steps: int,
              bt: torch.Tensor | None = None) -> torch.Tensor:
    """P1: ``grid_steps`` times the float32 sum over ``reps`` of ``a_r @ b``,
    summed in float32 (T, N). ``bt`` (b transposed, contiguous) may be given
    to keep the transpose out of a timed call."""
    T, H, N = _shapes(a, b, reps)
    if grid_steps < 1:
        raise ValueError(f"grid_steps must be >= 1; got {grid_steps}")
    bt = b.t().contiguous() if bt is None else bt
    if _build.check_tensors("mma_probe", a, [b, bt], tuple(DTYPES)) == "cpu":
        return mma_probe_ref(a, b, reps, grid_steps)
    depth = 256 if a.dtype == torch.int8 else 128
    if T % 128 or N % 128 or H % depth or H > 4 * depth or tuple(bt.shape) != (N, H):
        raise ValueError(f"the kernel takes T and N multiples of 128 and H a multiple of "
                         f"{depth} up to {4 * depth}; got T {T}, H {H}, N {N}")
    out = _launch(_lib(), a, bt, reps, grid_steps, _build.stream_ptr())
    LAUNCHES[f"mma_probe_{DTYPES[a.dtype]}"] += 1
    return out
