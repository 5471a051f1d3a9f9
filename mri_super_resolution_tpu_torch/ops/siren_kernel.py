"""SIREN kernels K1-K3: wrappers over the hand-written CUDA kernels of
``csrc/siren.cu``, ``csrc/siren_tc.cu``, ``csrc/siren_resident.cu`` and
``csrc/siren_stream.cu`` and their plain PyTorch versions.

Counterpart of ``mri_super_resolution_tpu/ops/pallas/siren_kernel.py``:

- :func:`siren_forward` (K3) <- ``siren_forward`` (fused MLP forward);
- :func:`siren_loss_grads` (K1) <- ``siren_loss_grads`` (one-pass forward,
  masked MSE and backward: loss and weight gradients), with its
  ``sample_weights`` (the acceptance-weighted MSE) and ``with_out_absmax``
  (max |out| over the real rows) options;
- :func:`siren_fused_bwd` (K2) <- the ``_bwd`` of ``siren_fused`` (recompute
  the forward, backprop an upstream gradient: dx and, when asked, dW/db);
- :func:`siren_fused` <- ``siren_fused``: K3 forward with K2 as its backward,
  as a ``torch.autograd.Function``;
- :func:`make_fused_weighted_value_and_grad` and
  :func:`make_fused_value_grad_absmax` <- the JAX adapters of the same names
  (the 2-D ensemble's and the soft-ERD fit's per-step gradients).

Weights are a flat list ``[W0, b0, ..., W_last, b_last]`` in torch
``nn.Linear`` layout: ``W_l`` is (out, in); the last layer has one output.
``acts`` names each layer's activation, as the JAX kernels' ``acts`` tuple:
``"sine"`` (``sin(omega_l z)``), ``"relu"`` or ``"none"`` on a hidden layer,
``"relu"`` or ``"none"`` on the last; the default is the plain Siren's, sine
on every hidden layer and none on the last. ``omega`` is one float for every
hidden layer or one per hidden layer (read only on sine layers).

A wrapper given CPU tensors runs the plain version (``*_ref``); given CUDA
tensors it launches the kernel or raises, and adds one to its entry of
:data:`LAUNCHES` (K1 under one key per variant: plain, weighted, absmax, or
both, and per variant on the weight-resident route (``*_resident``) and on
the streaming route (``*_stream``); each kernel's tensor-core route under
its own ``*_tc`` key). The
plain versions run on either device and are what the CPU tests and
``chip_smoke.py`` hold the kernels against.

The route, chosen from the shapes alone (:func:`tc_route`): a K1, K2 or K3
call with the plain Siren's activations (sine on every hidden layer, none
on the last), for K1 no ``sample_weights`` and no ``with_out_absmax``, and
the input and every hidden width a multiple of 128 (:data:`TC_TILE`) runs
on the tensor cores (``csrc/siren_tc.cu``: bf16x3 split products, float32
accumulation; the 3-D pipeline's 256 -> 512x4 -> 1, for K2 with or without
dW); every other call (ReLU codes, the 2-D ensemble's 64-wide Siren, odd
widths) on the SIMT kernels of ``csrc/siren.cu``, except that a K1 call
off the tensor-core route whose weights and one 32-row tile's working set
fit in one block's shared memory (:func:`resident_route`: the 2-D
ensemble's 2 -> 64x7 -> 1 and other small MLPs, with any of K1's options)
runs on the weight-resident kernel of ``csrc/siren_resident.cu``: two
launches a call instead of about one a layer and pass; and a K1 call that
neither takes whose hidden widths are equal multiples of 64 and whose plan
fits one block (:func:`stream_route`: the soft-ERD fit's SirenERD 2 ->
128x4 -> 128 -> 1 with ReLU codes and max |out|, with any of K1's options)
runs on the streaming tensor-core kernel of ``csrc/siren_stream.cu``: a
block a 128-row tile, the hidden layers' bf16x3 products on the tensor
cores, the weights streamed through shared memory, three launches a call.
:func:`k1_route` gives the order. No route is a fallback: a launch that
fails raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from mri_super_resolution_tpu_torch.ops import _build

# one count per wrapper (and per K1 variant), bumped once per kernel launch
# on a CUDA tensor
LAUNCHES: dict[str, int] = {"siren_forward": 0, "siren_loss_grads": 0,
                            "siren_loss_grads_weighted": 0,
                            "siren_loss_grads_absmax": 0,
                            "siren_loss_grads_weighted_absmax": 0,
                            "siren_loss_grads_tc": 0, "siren_fused_bwd": 0,
                            "siren_forward_tc": 0, "siren_fused_bwd_tc": 0,
                            "siren_loss_grads_resident": 0,
                            "siren_loss_grads_weighted_resident": 0,
                            "siren_loss_grads_absmax_resident": 0,
                            "siren_loss_grads_weighted_absmax_resident": 0,
                            "siren_loss_grads_stream": 0,
                            "siren_loss_grads_weighted_stream": 0,
                            "siren_loss_grads_absmax_stream": 0,
                            "siren_loss_grads_weighted_absmax_stream": 0}

ACT_CODES = {"none": 0, "sine": 1, "relu": 2}  # csrc/siren.cu's enum Act
TC_TILE = 128  # csrc/siren_tc.cu's block tile: every width but the output's a multiple
# csrc/siren_resident.cu: rows a tile, layers at most, and the shared memory
# a block may use on an H100 (bytes)
RES_ROWS, RES_MAX_LAYERS, RES_SMEM_MAX = 32, 16, 232_448
# csrc/siren_stream.cu: rows a tile (a block), W rows a ring stage, ring
# stages, the hidden width's step and layers at most
ST_TM, ST_RING, ST_STAGES, ST_H_STEP, ST_MAX_LAYERS = 128, 32, 2, 64, 16


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def loss_grads_key(weighted: bool, absmax: bool, route: str = "simt") -> str:
    """The :data:`LAUNCHES` key of a K1 variant on the ``"simt"``, the
    ``"resident"`` or the ``"stream"`` route."""
    return ("siren_loss_grads" + ("_weighted" if weighted else "")
            + ("_absmax" if absmax else "") + ("" if route == "simt" else f"_{route}"))


# --------------------------------------------------------------------------
# contract checks
# --------------------------------------------------------------------------


def _layer_dims(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> list[int]:
    if len(weights) % 2 or len(weights) < 4:
        raise ValueError("weights must be [W0, b0, ..., W_last, b_last] with at "
                         f"least one hidden layer; got {len(weights)} tensors")
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


def _omegas(omega: float | Sequence[float], n_hidden: int) -> list[float]:
    if isinstance(omega, (int, float)):
        return [float(omega)] * n_hidden
    omegas = [float(o) for o in omega]
    if len(omegas) != n_hidden:
        raise ValueError(f"{len(omegas)} omegas for {n_hidden} hidden layers")
    return omegas


def _acts(acts: Sequence[str] | None, n_layers: int) -> tuple[str, ...]:
    """Per-layer activations (default: sine on every hidden layer, none on
    the last), checked against what the kernels take."""
    if acts is None:
        return ("sine",) * (n_layers - 1) + ("none",)
    acts = tuple(acts)
    if len(acts) != n_layers:
        raise ValueError(f"{len(acts)} activations for {n_layers} layers")
    for a in acts:
        if a not in ACT_CODES:
            raise ValueError(f"unknown activation {a!r}; take {sorted(ACT_CODES)}")
    if acts[-1] == "sine":
        raise ValueError("the last layer takes 'relu' or 'none', not 'sine'")
    return acts


def _check(x: torch.Tensor, weights: Sequence[torch.Tensor], *others) -> str:
    return _build.check_tensors("SIREN", x, [*weights, *others], (torch.float32,))


def tc_route(dims: Sequence[int], acts: Sequence[str], weighted: bool = False,
             absmax: bool = False) -> bool:
    """Whether a K1, K2 or K3 call on the card runs on the tensor-core
    route: the plain Siren's activations, no sample weights and no max |out|
    (K1's options), and ``dims`` (input, hidden widths..., 1) with every
    width but the last a multiple of :data:`TC_TILE`."""
    return (not weighted and not absmax and len(dims) >= 3 and dims[-1] == 1
            and tuple(acts) == ("sine",) * (len(dims) - 2) + ("none",)
            and all(d % TC_TILE == 0 and d > 0 for d in dims[:-1]))


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def resident_smem_bytes(dims: Sequence[int]) -> int:
    """Bytes of shared memory K1's weight-resident kernel needs for ``dims``
    (input, hidden widths..., 1): every W and b zero-padded to widths of a
    multiple of 4, a z stash of 32 rows a hidden layer and three 32-row
    buffers at a row stride of the widest input or hidden width (padded so
    that a lane's 16-byte reads fall in distinct banks), and the last
    layer's 32 deltas; ``csrc/siren_resident.cu``'s ``make_plan``."""
    L = len(dims) - 1
    floats = sum(_pad4(dims[l + 1]) * (_pad4(dims[l]) + 1) for l in range(L))
    stride = _pad4(max(dims[:-1]))
    stride += 4 if (stride // 4) % 2 == 0 else 0
    return 4 * (floats + (L + 2) * RES_ROWS * stride + RES_ROWS)


def resident_route(dims: Sequence[int]) -> bool:
    """Whether a K1 call off the tensor-core route runs on the
    weight-resident kernel: at most :data:`RES_MAX_LAYERS` layers, one
    output, and :func:`resident_smem_bytes` within one block's
    :data:`RES_SMEM_MAX`. The options (sample weights, max |out|, the act
    codes) do not matter."""
    return (3 <= len(dims) <= RES_MAX_LAYERS + 1 and dims[-1] == 1
            and resident_smem_bytes(dims) <= RES_SMEM_MAX)


def stream_smem_bytes(dims: Sequence[int]) -> int:
    """Bytes of shared memory a block of K1's streaming route takes for
    ``dims`` (input, hidden widths..., 1): two buffers of hi and lo bf16
    planes of :data:`ST_TM` rows and :data:`ST_STAGES` ring stages of hi and
    lo planes of :data:`ST_RING` rows, each row of the hidden width H plus 8
    halves, and three floats a row; ``csrc/siren_stream.cu``'s
    ``stream_plan``."""
    S = dims[1] + 8
    return 8 * S * ST_TM + 4 * ST_STAGES * ST_RING * S + 12 * ST_TM


def stream_route(dims: Sequence[int]) -> bool:
    """Whether a K1 call that neither the tensor-core nor the
    weight-resident route takes runs on the streaming route: 3 to
    :data:`ST_MAX_LAYERS` layers, one output, every hidden width the same
    multiple of :data:`ST_H_STEP`, and :func:`stream_smem_bytes` within one
    block's :data:`RES_SMEM_MAX` (hidden widths of 64 and 128). The options
    (sample weights, max |out|, the act codes) do not matter."""
    hidden = set(dims[1:-1])
    return (4 <= len(dims) <= ST_MAX_LAYERS + 1 and dims[-1] == 1 and dims[0] >= 1
            and len(hidden) == 1 and dims[1] % ST_H_STEP == 0 and dims[1] > 0
            and stream_smem_bytes(dims) <= RES_SMEM_MAX)


def k1_route(dims: Sequence[int], acts: Sequence[str], weighted: bool = False,
             absmax: bool = False) -> str:
    """The route of a K1 call on the card, from the shapes alone, in this
    order: ``"tc"`` (:func:`tc_route`), ``"resident"``
    (:func:`resident_route`), ``"stream"`` (:func:`stream_route`), else
    ``"simt"`` (``csrc/siren.cu``)."""
    if tc_route(dims, acts, weighted, absmax):
        return "tc"
    if resident_route(dims):
        return "resident"
    return "stream" if stream_route(dims) else "simt"


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _act(z: torch.Tensor, act: str, omega: float) -> torch.Tensor:
    if act == "sine":
        return torch.sin(omega * z)
    if act == "relu":
        return torch.relu(z)
    return z


def siren_forward_ref(x: torch.Tensor, weights: Sequence[torch.Tensor],
                      omega: float | Sequence[float] = 30.0,
                      acts: Sequence[str] | None = None) -> torch.Tensor:
    """Plain K3: the MLP forward with torch ops (differentiable)."""
    n = len(weights) // 2
    omegas = _omegas(omega, n - 1)
    acts = _acts(acts, n)
    h = x
    for l in range(n - 1):
        h = _act(h @ weights[2 * l].T + weights[2 * l + 1], acts[l], omegas[l])
    return _act(h @ weights[-2].T + weights[-1], acts[-1], 1.0)


def _stash_forward(x, weights, omegas, acts):
    """Forward through the hidden layers, keeping each layer's input and its
    factor act'(z): omega cos(omega z) for sine, the step z > 0 for ReLU,
    None for none. Returns (inputs, factors, z of the last layer)."""
    inputs, factors = [x], []
    h = x
    for l in range(len(weights) // 2 - 1):
        z = h @ weights[2 * l].T + weights[2 * l + 1]
        if acts[l] == "sine":
            z = omegas[l] * z
            h = torch.sin(z)
            factors.append(omegas[l] * torch.cos(z))
        elif acts[l] == "relu":
            h = torch.relu(z)
            factors.append((z > 0).to(z.dtype))
        else:
            h = z
            factors.append(None)
        inputs.append(h)
    return inputs, factors, h @ weights[-2].T + weights[-1]


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
            delta = delta @ weights[2 * l]
            if factors[l - 1] is not None:
                delta = delta * factors[l - 1]
        elif need_dx:
            dx = delta @ weights[0]
    return dx, (grads if need_dw else None)


@torch.no_grad()
def siren_loss_grads_ref(x, weights, target, omega=30.0, n_rows=None, acts=None,
                         sample_weights=None, with_out_absmax=False):
    """Plain K1: ``(loss, grads)``, or ``(loss, out_absmax, grads)`` with
    ``with_out_absmax``. The loss is the MSE over the first ``n_rows`` rows
    (default all), each squared residual times its ``sample_weights`` row
    when given, normalised by ``n_rows * out_dim`` as the TPU kernel does;
    rows at and beyond ``n_rows`` contribute nothing. ``out_absmax`` is max
    |out| over those rows, after the last activation."""
    P = x.shape[0]
    n = len(weights) // 2
    n_rows = P if n_rows is None else int(n_rows)
    inv_n = 1.0 / (n_rows * target.shape[-1])
    acts = _acts(acts, n)
    inputs, factors, z = _stash_forward(x, weights, _omegas(omega, n - 1), acts)
    out = _act(z, acts[-1], 1.0)
    real = torch.arange(P, device=x.device)[:, None] < n_rows
    r = torch.where(real, out - target, torch.zeros_like(out))
    wr = r if sample_weights is None else sample_weights * r
    loss = (wr * r).sum() * inv_n
    delta = (2.0 * inv_n) * wr
    if acts[-1] == "relu":
        delta = delta * (z > 0).to(z.dtype)
    _, grads = _backprop(weights, inputs, factors, delta, True, False)
    if with_out_absmax:
        absmax = torch.where(real, out.abs(), torch.zeros_like(out)).max()
        return loss, absmax, grads
    return loss, grads


@torch.no_grad()
def siren_fused_bwd_ref(x, weights, g, omega=30.0, need_dw=True, need_dx=True,
                        acts=None):
    """Plain K2: ``(dx, grads)`` for the upstream gradient ``g`` (P, 1);
    ``None`` in place of what was not asked for."""
    n = len(weights) // 2
    acts = _acts(acts, n)
    inputs, factors, z = _stash_forward(x, weights, _omegas(omega, n - 1), acts)
    if acts[-1] == "relu":
        g = g * (z > 0).to(z.dtype)
    return _backprop(weights, inputs, factors, g, need_dw, need_dx)


def split_bf16x3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the tensor-core route's operand split: ``hi =
    bf16(x)``, ``lo = bf16(x - hi)``, both rounded to nearest even, so that
    ``|x - hi - lo| <= 2^-16 |x|``; the route's products are ``hi hi + hi lo
    + lo hi`` in float32."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(x.dtype)).to(torch.bfloat16)


# --------------------------------------------------------------------------
# CUDA launches
# --------------------------------------------------------------------------


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.siren_partial_floats.argtypes = [i, p, i]
    lib.siren_partial_floats.restype = ctypes.c_longlong
    lib.siren_forward_f32.argtypes = [p, i, p, i, p, p, p, p, p, p, p, p]
    lib.siren_forward_f32.restype = i
    lib.siren_loss_grads_f32.argtypes = [p, i, i, p, i, p, p, p, p, p, p, f, p, p, p, p,
                                         p, p, p, p, p, p]
    lib.siren_loss_grads_f32.restype = i
    lib.siren_fused_bwd_f32.argtypes = [p, i, p, i, p, p, p, p, p, p, p, p, p, p, p, p,
                                        p, p]
    lib.siren_fused_bwd_f32.restype = i


def _lib() -> ctypes.CDLL:
    return _build.library("siren", _declare)


def _tc_declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.siren_tc_workspace_bytes.argtypes = [i, p, i]
    lib.siren_tc_workspace_bytes.restype = ctypes.c_longlong
    lib.siren_loss_grads_tc.argtypes = [p, i, i, p, i, p, p, p, p, f, p, p, p, p, p]
    lib.siren_loss_grads_tc.restype = i
    lib.siren_forward_tc_workspace_bytes.argtypes = [i, p, i]
    lib.siren_forward_tc_workspace_bytes.restype = ctypes.c_longlong
    lib.siren_forward_tc.argtypes = [p, i, p, i, p, p, p, p, p, p]
    lib.siren_forward_tc.restype = i
    lib.siren_fused_bwd_tc_workspace_bytes.argtypes = [i, p, i, i]
    lib.siren_fused_bwd_tc_workspace_bytes.restype = ctypes.c_longlong
    lib.siren_fused_bwd_tc.argtypes = [p, i, p, i, p, p, p, p, p, p, p, p, p]
    lib.siren_fused_bwd_tc.restype = i


def _tc_lib() -> ctypes.CDLL:
    return _build.library("siren_tc", _tc_declare)


def _res_declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.siren_resident_work_floats.argtypes = [i, p, i]
    lib.siren_resident_work_floats.restype = ctypes.c_longlong
    lib.siren_loss_grads_resident.argtypes = [p, i, i, p, i, p, p, p, p, p, f, p, p, p]
    lib.siren_loss_grads_resident.restype = i


def _res_lib() -> ctypes.CDLL:
    return _build.library("siren_resident", _res_declare)


def _stream_declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.siren_stream_smem_bytes.argtypes = [p, i]
    lib.siren_stream_smem_bytes.restype = ctypes.c_longlong
    lib.siren_stream_work_floats.argtypes = [i, p, i]
    lib.siren_stream_work_floats.restype = ctypes.c_longlong
    lib.siren_loss_grads_stream.argtypes = [p, i, i, p, i, p, p, p, p, p, f, p, p, p]
    lib.siren_loss_grads_stream.restype = i


def _stream_lib() -> ctypes.CDLL:
    return _build.library("siren_stream", _stream_declare)


class _Args:
    """ctypes views of the shared arguments; keeps the arrays alive."""

    def __init__(self, x, weights, omega, acts):
        self.dims_list = _layer_dims(x, weights)
        self.n_layers = len(weights) // 2
        self.dims = (ctypes.c_int * len(self.dims_list))(*self.dims_list)
        codes = [ACT_CODES[a] for a in _acts(acts, self.n_layers)]
        self.acts = (ctypes.c_int * len(codes))(*codes)
        self.W = _build.ptr_array(weights[0::2])
        self.b = _build.ptr_array(weights[1::2])
        omegas = _omegas(omega, self.n_layers - 1)
        self.omegas = (ctypes.c_float * len(omegas))(*omegas)
        self.P = int(x.shape[0])
        self.width = max(self.dims_list[1:-1])

    def ptr(self, arr) -> ctypes.c_void_p:
        return ctypes.cast(arr, ctypes.c_void_p)


def _stash_buffers(a: _Args, like: torch.Tensor):
    P = a.P
    acts = [torch.empty(P, d, dtype=like.dtype, device=like.device)
            for d in a.dims_list[1:-1]]
    facts = [torch.empty_like(t) for t in acts]
    delta0 = torch.empty(P, a.width, dtype=like.dtype, device=like.device)
    delta1 = torch.empty_like(delta0)
    return acts, facts, delta0, delta1


def _partial(lib, a: _Args, like: torch.Tensor) -> torch.Tensor:
    n = lib.siren_partial_floats(a.P, a.ptr(a.dims), a.n_layers)
    return torch.empty(int(n), dtype=like.dtype, device=like.device)


def _launch_forward(lib, x, weights, omega, stream, acts=None) -> torch.Tensor:
    a = _Args(x, weights, omega, acts)
    out = torch.empty(a.P, 1, dtype=x.dtype, device=x.device)
    buf0 = torch.empty(a.P, a.width, dtype=x.dtype, device=x.device)
    buf1 = torch.empty_like(buf0)
    rc = lib.siren_forward_f32(
        x.data_ptr(), a.P, a.ptr(a.dims), a.n_layers, a.ptr(a.acts), a.W, a.b,
        a.ptr(a.omegas), out.data_ptr(), buf0.data_ptr(), buf1.data_ptr(), stream)
    _build.raise_on(rc, "siren_forward")
    return out


def _launch_loss_grads(lib, x, weights, target, omega, n_rows, stream, acts=None,
                       sample_weights=None, with_out_absmax=False):
    a = _Args(x, weights, omega, acts)
    inv_n = 1.0 / (n_rows * target.shape[-1])
    stash, facts, delta0, delta1 = _stash_buffers(a, x)
    partial = _partial(lib, a, x)
    grads = [torch.empty_like(w) for w in weights]
    loss = torch.empty((), dtype=x.dtype, device=x.device)
    absmax = torch.empty((), dtype=x.dtype, device=x.device) if with_out_absmax else None
    rc = lib.siren_loss_grads_f32(
        x.data_ptr(), a.P, int(n_rows), a.ptr(a.dims), a.n_layers, a.ptr(a.acts), a.W,
        a.b, a.ptr(a.omegas), target.data_ptr(),
        None if sample_weights is None else sample_weights.data_ptr(), inv_n,
        _build.ptr_array(stash), _build.ptr_array(facts), delta0.data_ptr(),
        delta1.data_ptr(), partial.data_ptr(), _build.ptr_array(grads[0::2]),
        _build.ptr_array(grads[1::2]), loss.data_ptr(),
        None if absmax is None else absmax.data_ptr(), stream)
    _build.raise_on(rc, "siren_loss_grads")
    return (loss, absmax, grads) if with_out_absmax else (loss, grads)


def _tc_work(nbytes: int, a: _Args, what: str, like: torch.Tensor) -> torch.Tensor:
    """The workspace of a tensor-core call, whose size query gave ``nbytes``
    (-1: the route does not take these widths)."""
    if nbytes < 0:
        raise ValueError(f"the tensor-core {what} does not take widths {a.dims_list}")
    return torch.empty(nbytes, dtype=torch.uint8, device=like.device)


def _launch_loss_grads_tc(lib, x, weights, target, omega, n_rows, stream):
    """K1 on the tensor-core route (the shapes :func:`tc_route` takes)."""
    a = _Args(x, weights, omega, None)
    work = _tc_work(lib.siren_tc_workspace_bytes(a.P, a.ptr(a.dims), a.n_layers), a, "K1", x)
    grads = [torch.empty_like(w) for w in weights]
    loss = torch.empty((), dtype=x.dtype, device=x.device)
    rc = lib.siren_loss_grads_tc(
        x.data_ptr(), a.P, int(n_rows), a.ptr(a.dims), a.n_layers, a.W, a.b,
        a.ptr(a.omegas), target.data_ptr(), 1.0 / (n_rows * target.shape[-1]),
        work.data_ptr(), _build.ptr_array(grads[0::2]), _build.ptr_array(grads[1::2]),
        loss.data_ptr(), stream)
    _build.raise_on(rc, "siren_loss_grads_tc")
    return loss, grads


class _SlotCall:
    """The ctypes arguments of K1 calls on a route that sums per-block
    slots (``route``: ``"resident"`` or ``"stream"``) of one shape and one
    set of codes and omegas, built once; each call fills in the weights'
    pointers."""

    def __init__(self, lib, route: str, P: int, dims: tuple, codes: tuple, omegas: tuple):
        L = len(dims) - 1
        self.L = L
        self._arrays = ((ctypes.c_int * len(dims))(*dims), (ctypes.c_int * L)(*codes),
                        (ctypes.c_float * (L - 1))(*omegas), (ctypes.c_void_p * (2 * L))())
        self.dims, self.codes, self.omegas, self.ptrs_arg = (ctypes.cast(a, ctypes.c_void_p)
                                                             for a in self._arrays)
        self.ptrs = self._arrays[3]  # the weights' pointers, filled in each call
        self.work = int(getattr(lib, f"siren_{route}_work_floats")(P, self.dims, L))
        if self.work < 0:
            raise ValueError(f"K1's {route} route does not take widths {list(dims)}")
        self.launch = getattr(lib, f"siren_loss_grads_{route}")
        # each grad's (shape, stride, offset) in the output buffer: W0, b0, W1, b1, ...
        self.views, at = [], 0
        for l in range(L):
            for shape, stride in (((dims[l + 1], dims[l]), (dims[l], 1)), ((dims[l + 1],), (1,))):
                self.views.append((shape, stride, at))
                at += int(torch.Size(shape).numel())
        self.n_params = at


_SLOT_CALLS: dict[tuple, _SlotCall] = {}


def _launch_loss_grads_slots(route, lib, x, weights, target, omega, n_rows, stream, acts=None,
                             sample_weights=None, with_out_absmax=False):
    """K1 on the weight-resident or the streaming route (``route``; the
    widths :func:`resident_route` or :func:`stream_route` takes): one
    workspace and one output buffer a call, whose views are the returned
    loss, max |out| and grads."""
    n = len(weights) // 2
    dims = tuple(int(s) for s in x.shape[1:]) + tuple(int(w.shape[0]) for w in weights[0::2])
    key = (int(x.shape[0]), dims, tuple(ACT_CODES[a] for a in _acts(acts, n)),
           tuple(_omegas(omega, n - 1)))
    # the resident route's blocks a call: one an SM of the device
    call = _SLOT_CALLS.get((route, id(lib), key, x.device))
    if call is None:
        call = _SLOT_CALLS[route, id(lib), key, x.device] = _SlotCall(lib, route, *key)
    call.ptrs[:] = [w.data_ptr() for w in weights]
    work = torch.empty(call.work, dtype=x.dtype, device=x.device)
    out = torch.empty(call.n_params + 2, dtype=x.dtype, device=x.device)
    rc = call.launch(
        x.data_ptr(), key[0], int(n_rows), call.dims, call.L, call.codes,
        call.ptrs_arg, call.omegas, target.data_ptr(),
        None if sample_weights is None else sample_weights.data_ptr(),
        1.0 / (n_rows * target.shape[-1]), work.data_ptr(), out.data_ptr(), stream)
    _build.raise_on(rc, f"siren_loss_grads_{route}")
    grads = [out.as_strided(*v) for v in call.views]
    loss = out[call.n_params]
    return (loss, out[call.n_params + 1], grads) if with_out_absmax else (loss, grads)


def _launch_loss_grads_resident(lib, *args, **kwargs):
    """K1 on the weight-resident route (``csrc/siren_resident.cu``)."""
    return _launch_loss_grads_slots("resident", lib, *args, **kwargs)


def _launch_loss_grads_stream(lib, *args, **kwargs):
    """K1 on the streaming tensor-core route (``csrc/siren_stream.cu``)."""
    return _launch_loss_grads_slots("stream", lib, *args, **kwargs)


def _launch_forward_tc(lib, x, weights, omega, stream) -> torch.Tensor:
    """K3 on the tensor-core route (the shapes :func:`tc_route` takes)."""
    a = _Args(x, weights, omega, None)
    work = _tc_work(lib.siren_forward_tc_workspace_bytes(a.P, a.ptr(a.dims), a.n_layers), a,
                    "K3", x)
    out = torch.empty(a.P, 1, dtype=x.dtype, device=x.device)
    rc = lib.siren_forward_tc(x.data_ptr(), a.P, a.ptr(a.dims), a.n_layers, a.W, a.b,
                              a.ptr(a.omegas), work.data_ptr(), out.data_ptr(), stream)
    _build.raise_on(rc, "siren_forward_tc")
    return out


def _launch_fused_bwd_tc(lib, x, weights, g, omega, need_dw, need_dx, stream):
    """K2 on the tensor-core route (the shapes :func:`tc_route` takes)."""
    a = _Args(x, weights, omega, None)
    work = _tc_work(lib.siren_fused_bwd_tc_workspace_bytes(a.P, a.ptr(a.dims), a.n_layers,
                                                           int(need_dw)), a, "K2", x)
    grads = [torch.empty_like(w) for w in weights] if need_dw else None
    dx = torch.empty_like(x) if need_dx else None
    rc = lib.siren_fused_bwd_tc(
        x.data_ptr(), a.P, a.ptr(a.dims), a.n_layers, a.W, a.b, a.ptr(a.omegas),
        g.data_ptr(), work.data_ptr(),
        _build.ptr_array(grads[0::2]) if need_dw else None,
        _build.ptr_array(grads[1::2]) if need_dw else None,
        None if dx is None else dx.data_ptr(), stream)
    _build.raise_on(rc, "siren_fused_bwd_tc")
    return dx, grads


def _launch_fused_bwd(lib, x, weights, g, omega, need_dw, need_dx, stream, acts=None):
    a = _Args(x, weights, omega, acts)
    stash, facts, delta0, delta1 = _stash_buffers(a, x)
    partial = _partial(lib, a, x)
    grads = [torch.empty_like(w) for w in weights] if need_dw else None
    dx = torch.empty_like(x) if need_dx else None
    dW = _build.ptr_array(grads[0::2]) if need_dw else None
    db = _build.ptr_array(grads[1::2]) if need_dw else None
    rc = lib.siren_fused_bwd_f32(
        x.data_ptr(), a.P, a.ptr(a.dims), a.n_layers, a.ptr(a.acts), a.W, a.b,
        a.ptr(a.omegas), g.data_ptr(), _build.ptr_array(stash), _build.ptr_array(facts),
        delta0.data_ptr(), delta1.data_ptr(), partial.data_ptr(), dW, db,
        None if dx is None else dx.data_ptr(), stream)
    _build.raise_on(rc, "siren_fused_bwd")
    return dx, grads


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def siren_forward(x: torch.Tensor, weights: Sequence[torch.Tensor],
                  omega: float | Sequence[float] = 30.0,
                  acts: Sequence[str] | None = None) -> torch.Tensor:
    """K3: the MLP output (P, 1)."""
    weights = list(weights)
    dims = _layer_dims(x, weights)
    acts = _acts(acts, len(weights) // 2)
    if _check(x, weights) == "cpu":
        return siren_forward_ref(x, weights, omega, acts)
    weights = [w.detach() for w in weights]
    if tc_route(dims, acts):
        out = _launch_forward_tc(_tc_lib(), x, weights, omega, _build.stream_ptr())
        LAUNCHES["siren_forward_tc"] += 1
        return out
    out = _launch_forward(_lib(), x, weights, omega, _build.stream_ptr(), acts)
    LAUNCHES["siren_forward"] += 1
    return out


def siren_loss_grads(x: torch.Tensor, weights: Sequence[torch.Tensor],
                     target: torch.Tensor, omega: float | Sequence[float] = 30.0,
                     n_rows: int | None = None, acts: Sequence[str] | None = None,
                     sample_weights: torch.Tensor | None = None,
                     with_out_absmax: bool = False):
    """K1: ``(loss, grads)`` of ``mean((MLP(x) - target)^2)`` over the first
    ``n_rows`` rows (default all), with ``grads`` matching ``weights``;
    ``sample_weights`` (P, 1) weighs each squared residual (the mean stays
    over ``n_rows``); ``with_out_absmax`` returns ``(loss, out_absmax,
    grads)`` with ``out_absmax`` = max |MLP(x)| over those rows. On the
    weight-resident and the streaming routes the loss, max |out| and grads
    are views of one buffer that the call allocates."""
    weights = list(weights)
    dims = _layer_dims(x, weights)
    acts = _acts(acts, len(weights) // 2)
    if target.shape != (x.shape[0], 1):
        raise ValueError(f"target must be ({x.shape[0]}, 1); got {tuple(target.shape)}")
    if sample_weights is not None and sample_weights.shape != (x.shape[0], 1):
        raise ValueError(f"sample_weights must be ({x.shape[0]}, 1); got "
                         f"{tuple(sample_weights.shape)}")
    n_rows = x.shape[0] if n_rows is None else int(n_rows)
    if not 0 < n_rows <= x.shape[0]:
        raise ValueError(f"n_rows {n_rows} outside (0, {x.shape[0]}]")
    extra = [] if sample_weights is None else [sample_weights]
    if _check(x, weights, target, *extra) == "cpu":
        return siren_loss_grads_ref(x, weights, target, omega, n_rows, acts,
                                    sample_weights, with_out_absmax)
    weighted = sample_weights is not None
    weights = [w.detach() for w in weights]
    route = k1_route(dims, acts, weighted, with_out_absmax)
    if route == "tc":
        out = _launch_loss_grads_tc(_tc_lib(), x, weights, target, omega, n_rows,
                                    _build.stream_ptr())
        LAUNCHES["siren_loss_grads_tc"] += 1
        return out
    if route == "simt":
        out = _launch_loss_grads(_lib(), x, weights, target, omega, n_rows,
                                 _build.stream_ptr(), acts, sample_weights, with_out_absmax)
    else:
        lib = _res_lib() if route == "resident" else _stream_lib()
        out = _launch_loss_grads_slots(route, lib, x, weights, target, omega, n_rows,
                                       _build.stream_ptr(), acts, sample_weights,
                                       with_out_absmax)
    LAUNCHES[loss_grads_key(weighted, with_out_absmax, route)] += 1
    return out


def siren_fused_bwd(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    g: torch.Tensor, omega: float | Sequence[float] = 30.0,
                    need_dw: bool = True, need_dx: bool = True,
                    acts: Sequence[str] | None = None):
    """K2: ``(dx, grads)`` for the upstream gradient ``g`` (P, 1) of the MLP
    output; ``None`` in place of what was not asked for."""
    weights = list(weights)
    dims = _layer_dims(x, weights)
    acts = _acts(acts, len(weights) // 2)
    if g.shape != (x.shape[0], 1):
        raise ValueError(f"g must be ({x.shape[0]}, 1); got {tuple(g.shape)}")
    if _check(x, weights, g) == "cpu":
        return siren_fused_bwd_ref(x, weights, g, omega, need_dw, need_dx, acts)
    weights = [w.detach() for w in weights]
    if tc_route(dims, acts):
        out = _launch_fused_bwd_tc(_tc_lib(), x, weights, g, omega, need_dw, need_dx,
                                   _build.stream_ptr())
        LAUNCHES["siren_fused_bwd_tc"] += 1
        return out
    out = _launch_fused_bwd(_lib(), x, weights, g, omega, need_dw, need_dx,
                            _build.stream_ptr(), acts)
    LAUNCHES["siren_fused_bwd"] += 1
    return out


class _SirenFused(torch.autograd.Function):
    """K3 forward; K2 backward (dx always when asked, dW/db only when some
    weight requires grad)."""

    @staticmethod
    def forward(ctx, x, omega, acts, *weights):
        ctx.omega, ctx.acts = omega, acts
        ctx.save_for_backward(x, *weights)
        return siren_forward(x, weights, omega, acts)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        need_dw = any(ctx.needs_input_grad[3:])
        dx, grads = siren_fused_bwd(x, weights, g.contiguous(), ctx.omega,
                                    need_dw=need_dw, need_dx=need_dx, acts=ctx.acts)
        return (dx, None, None, *(grads if need_dw else [None] * len(weights)))


def siren_fused(x: torch.Tensor, weights: Sequence[torch.Tensor],
                omega: float | Sequence[float] = 30.0,
                acts: Sequence[str] | None = None) -> torch.Tensor:
    """Differentiable MLP forward: K3 forward, K2 backward."""
    omega = omega if isinstance(omega, (int, float)) else tuple(omega)
    return _SirenFused.apply(x, omega, None if acts is None else tuple(acts), *weights)


# --------------------------------------------------------------------------
# adapters for the fit loops
# --------------------------------------------------------------------------


def _model_omega_acts(model) -> tuple[float, tuple[str, ...]]:
    """One omega for every sine layer and the trunk's activations of a
    port ``Siren`` or ``SirenERD``; raises for distinct first and hidden
    omegas, as the JAX adapters do."""
    first, hidden = float(model.first_omega_0), float(model.hidden_omega_0)
    if first != hidden:
        raise ValueError("distinct first/hidden omega is not supported here")
    return hidden, tuple(model.acts)


def make_fused_weighted_value_and_grad(model):
    """``vag(params, x, target, sample_weights) -> (loss, grads)``: the
    acceptance-weighted MSE of the 2-D directional ensemble in one K1 pass
    (``make_fused_weighted_value_and_grad`` of the JAX package; no width
    padding, the kernel takes any width). ``params`` in ``model.weights()``
    order."""
    omega, acts = _model_omega_acts(model)

    def vag(params, x, target, sample_weights):
        return siren_loss_grads(x, params, target, omega, acts=acts,
                                sample_weights=sample_weights)

    return vag


def make_fused_value_grad_absmax(model):
    """``vag(params, x, target) -> (loss, out_absmax, grads)``: the trunk's
    MSE gradient and the collapse signal max |out| in one K1 pass
    (``make_fused_value_grad_absmax`` of the JAX package). ``params`` are
    the trunk's, in ``model.weights()`` order."""
    omega, acts = _model_omega_acts(model)

    def vag(params, x, target):
        return siren_loss_grads(x, params, target, omega, acts=acts,
                                with_out_absmax=True)

    return vag
