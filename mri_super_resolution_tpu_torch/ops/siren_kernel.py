"""SIREN kernels K1-K3: wrappers over the hand-written CUDA kernels of
``csrc/siren.cu``, ``csrc/siren_wg.cu``, ``csrc/siren_resident_tc.cu`` and
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
  (the 2-D ensemble's and the soft-ERD fit's per-step gradients);
- :func:`siren_loss_grads_batched` (K1 with a batch axis) <- ``jax.vmap``
  over ``siren_loss_grads``, which adds a batch axis to the Pallas kernel's
  grid: one launch over D stacked MLPs that share x (the hybrid fit's four
  per-TE SIRENs, the 2-D ensemble's three directions), with the adapters
  :func:`make_fused_value_and_grad_batched` and
  :func:`make_fused_weighted_value_and_grad_batched`.

Weights are a flat list ``[W0, b0, ..., W_last, b_last]`` in torch
``nn.Linear`` layout: ``W_l`` is (out, in); the last layer has one output.
``acts`` names each layer's activation, as the JAX kernels' ``acts`` tuple:
``"sine"`` (``sin(omega_l z)``), ``"relu"`` or ``"none"`` on a hidden layer,
``"relu"`` or ``"none"`` on the last; the default is the plain Siren's, sine
on every hidden layer and none on the last. ``omega`` is one float for every
hidden layer or one per hidden layer (read only on sine layers).

A wrapper given CPU tensors runs the plain version (``*_ref``); given CUDA
tensors it launches the kernel or raises, and adds one to its entry of
:data:`LAUNCHES` (K1 under one key per variant and route,
:func:`loss_grads_key`: plain, weighted, absmax, or both, on the SIMT
route (no suffix) and on the streaming route (``*_stream``); each kernel's
tensor-core route, ``csrc/siren_wg.cu``, under its own ``*_wg`` key;
batched K1 under ``*_batched`` keys, its tensor-core class,
``csrc/siren_wg.cu`` too, under ``siren_loss_grads_wg_batched``, and the
2-D ensemble's, ``csrc/siren_resident_tc.cu``, under
``siren_loss_grads_[weighted_]resident_tc_batched``). The plain versions
run on either device and are what the CPU tests and ``chip_smoke.py`` hold
the kernels against. Each public wrapper is a span of ``utils/profiling.py``
(``kernel.<name>``) on every device, and the ctypes call of every route a
``kernel.launch`` span inside it: the wrapper's self time is its checks,
route, allocations and pointer arrays. Every route calls its source through
one cached call plan (:class:`_Plan`).

The route, chosen from the shapes alone (:func:`tc_route`): a K1, K2 or K3
call with the plain Siren's activations (sine on every hidden layer, none
on the last), for K1 no ``sample_weights`` and no ``with_out_absmax``, the
input and every hidden width a multiple of 128 (:data:`TC_TILE`), the last
hidden width at most :data:`WG_MAX_LAST` and at most :data:`WG_MAX_LAYERS`
layers runs on the tensor cores (``csrc/siren_wg.cu``: ``wgmma`` passes fed
by TMA, bf16x3 split products, float32 accumulation, the float32 stash; the
3-D pipeline's 256 -> 512x4 -> 1, for K2 with or without dW); every other
call (ReLU codes, the 2-D ensemble's 64-wide Siren, odd widths) on the SIMT
kernels of ``csrc/siren.cu``, except that a K1 call off the tensor-core
route whose hidden widths are equal multiples of 64 and whose plan fits one
block (:func:`stream_route`: the soft-ERD fit's SirenERD 2 -> 128x4 -> 128
-> 1 with ReLU codes and max |out|, the 2-D ensemble's 2 -> 64x7 -> 1, with
any of K1's options) runs on the streaming tensor-core kernel of
``csrc/siren_stream.cu``: a block a 128-row tile, the hidden layers' bf16x3
products on the tensor cores, the weights streamed through shared memory,
three launches a call. :func:`k1_route` gives the order. No route is a
fallback: a launch that fails raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from mri_super_resolution_tpu_torch.ops import _build
from mri_super_resolution_tpu_torch.utils.profiling import span

# one count per wrapper (and per K1 variant), bumped once per kernel launch
# on a CUDA tensor
LAUNCHES: dict[str, int] = {"siren_forward": 0, "siren_loss_grads": 0,
                            "siren_loss_grads_weighted": 0,
                            "siren_loss_grads_absmax": 0,
                            "siren_loss_grads_weighted_absmax": 0,
                            "siren_loss_grads_wg": 0, "siren_fused_bwd": 0,
                            "siren_forward_wg": 0, "siren_fused_bwd_wg": 0,
                            "siren_loss_grads_stream": 0,
                            "siren_loss_grads_weighted_stream": 0,
                            "siren_loss_grads_absmax_stream": 0,
                            "siren_loss_grads_weighted_absmax_stream": 0,
                            "siren_loss_grads_wg_batched": 0,
                            "siren_loss_grads_resident_tc_batched": 0,
                            "siren_loss_grads_weighted_resident_tc_batched": 0}

ACT_CODES = {"none": 0, "sine": 1, "relu": 2}  # csrc/siren.cu's enum Act
TC_TILE = 128  # csrc/siren_wg.cu's unit tile: every width but the output's a multiple
# csrc/siren_wg.cu: the last hidden width (its last-layer kernel's) and layers at most
WG_MAX_LAST, WG_MAX_LAYERS = 2048, 16
SMEM_MAX = 232_448  # the shared memory a block may use on an H100 (bytes)
# csrc/siren_stream.cu: rows a tile (a block), W rows a ring stage, ring
# stages, the hidden width's step and layers at most
ST_TM, ST_RING, ST_STAGES, ST_H_STEP, ST_MAX_LAYERS = 128, 32, 2, 64, 16
# csrc/siren_resident_tc.cu: the hidden width, rows a tile, hidden layers
# and input width at most
RT_H, RT_ROWS, RT_MAX_HIDDEN, RT_MAX_D0 = 64, 32, 7, 4


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def loss_grads_key(weighted: bool, absmax: bool, route: str = "simt") -> str:
    """The :data:`LAUNCHES` key of a K1 variant on a route of
    :func:`k1_route` (``"wg"`` takes neither option) or on the batched
    ``"resident_tc"`` route, which adds ``_batched``."""
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
    width but the last a multiple of :data:`TC_TILE`, the last hidden one at
    most :data:`WG_MAX_LAST`, and at most :data:`WG_MAX_LAYERS` layers."""
    return (not weighted and not absmax and 3 <= len(dims) <= WG_MAX_LAYERS + 1
            and dims[-1] == 1 and dims[-2] <= WG_MAX_LAST
            and tuple(acts) == ("sine",) * (len(dims) - 2) + ("none",)
            and all(d % TC_TILE == 0 and d > 0 for d in dims[:-1]))


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
    """Whether a K1 call off the tensor-core route runs on the streaming
    route: 3 to :data:`ST_MAX_LAYERS` layers, one output, every hidden
    width the same multiple of :data:`ST_H_STEP`, and
    :func:`stream_smem_bytes` within one block's :data:`SMEM_MAX` (hidden
    widths of 64 and 128). The options (sample weights, max |out|, the act
    codes, per-layer omegas) do not matter."""
    hidden = set(dims[1:-1])
    return (4 <= len(dims) <= ST_MAX_LAYERS + 1 and dims[-1] == 1 and dims[0] >= 1
            and len(hidden) == 1 and dims[1] % ST_H_STEP == 0 and dims[1] > 0
            and stream_smem_bytes(dims) <= SMEM_MAX)


def resident_tc_smem_bytes(dims: Sequence[int]) -> int:
    """Bytes of shared memory a block of the batched K1-w kernel
    (``csrc/siren_resident_tc.cu``'s ``rt_plan``) takes for ``dims`` (d0,
    64 x NH, 1): hi and lo bf16 planes of each 64 x 64 W, W0 as 64 x 4 and
    the biases and the head in float32, a stash of hi/lo planes and a
    float32 factor of 32 rows for every hidden layer but the last, two delta
    buffers of hi/lo planes, the head's 4 x 32 partial sums and an
    mbarrier."""
    nhh = len(dims) - 3
    return (nhh * 4 * RT_H * RT_H + 16 * RT_H + 4 * RT_H * (nhh + 1) + 4 * RT_H + 16
            + nhh * 8 * RT_ROWS * RT_H + 8 * RT_ROWS * RT_H + 16 * RT_ROWS + 16)


def resident_tc_route(dims: Sequence[int], acts: Sequence[str],
                      omega: float | Sequence[float]) -> bool:
    """Whether a batched K1 call on the card runs on the batched K1-w
    kernel (``csrc/siren_resident_tc.cu``): an input width of 1 to
    :data:`RT_MAX_D0`, 2 to :data:`RT_MAX_HIDDEN` hidden layers all
    :data:`RT_H` wide, one output, sine on every hidden layer with one
    omega and none on the last (the 2-D ensemble's Siren 2 -> 64x7 -> 1);
    with or without sample weights."""
    nh = len(dims) - 2
    one_omega = isinstance(omega, (int, float)) or len(set(float(o) for o in omega)) == 1
    return (2 <= nh <= RT_MAX_HIDDEN and 1 <= dims[0] <= RT_MAX_D0 and dims[-1] == 1
            and all(d == RT_H for d in dims[1:-1]) and one_omega
            and tuple(acts) == ("sine",) * nh + ("none",))


def batched_route(dims: Sequence[int], acts: Sequence[str], omega: float | Sequence[float],
                  weighted: bool = False) -> str:
    """The route of a batched K1 call on the card, from the shapes alone:
    ``"wg"`` (K1's tensor-core class, :func:`tc_route`: ``csrc/siren_wg.cu``),
    ``"resident_tc"`` (:func:`resident_tc_route`), else ``"slots"``: the D
    slots in turn through :func:`siren_loss_grads` on its own route (the
    2-D ensemble's widths with ReLU codes or per-layer omegas on the
    streaming route, other widths on the streaming or the SIMT route)."""
    if tc_route(dims, acts, weighted):
        return "wg"
    return "resident_tc" if resident_tc_route(dims, acts, omega) else "slots"


def k1_route(dims: Sequence[int], acts: Sequence[str], weighted: bool = False,
             absmax: bool = False) -> str:
    """The route of a K1 call on the card, from the shapes alone, in this
    order: ``"wg"`` (:func:`tc_route`: ``csrc/siren_wg.cu``), ``"stream"``
    (:func:`stream_route`: ``csrc/siren_stream.cu``), else ``"simt"``
    (``csrc/siren.cu``, any widths)."""
    if tc_route(dims, acts, weighted, absmax):
        return "wg"
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


def _stacked_linear(h: torch.Tensor, W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h W^T + b for D stacked layers W (D, out, in), b (D, out): h is the
    shared (P, in) input or the slots' (D, P, in) activations."""
    z = torch.einsum("pi,doi->dpo", h, W) if h.dim() == 2 else torch.bmm(h, W.transpose(1, 2))
    return z + b[:, None, :]


def siren_forward_batched_ref(x: torch.Tensor, weights: Sequence[torch.Tensor],
                              omega: float | Sequence[float] = 30.0,
                              acts: Sequence[str] | None = None) -> torch.Tensor:
    """Plain K3 over D stacked MLPs (each W (D, out, in), b (D, out)) on one
    x (P, d_in): the (D, P, 1) outputs, ``einsum``/``bmm`` over the stacked
    weights (differentiable); ``jax.vmap`` of the forward."""
    n = len(weights) // 2
    omegas = _omegas(omega, n - 1) + [1.0]
    acts = _acts(acts, n)
    h = x
    for l in range(n):
        h = _act(_stacked_linear(h, weights[2 * l], weights[2 * l + 1]), acts[l], omegas[l])
    return h


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


_BATCHED_DIMS: dict[tuple, tuple[tuple[int, ...], int]] = {}


def _batched_dims(x: torch.Tensor,
                  weights: Sequence[torch.Tensor]) -> tuple[tuple[int, ...], int]:
    """(the layer widths, D) of stacked weights ``[W0, b0, ...]``, each W
    (D, out, in) and b (D, out), over a shared x (P, d_in); checked once a
    set of shapes."""
    key = (x.shape, *(w.shape for w in weights))
    known = _BATCHED_DIMS.get(key)
    if known is not None:
        return known
    if len(weights) % 2 or len(weights) < 4:
        raise ValueError("weights must be [W0, b0, ..., W_last, b_last] with at "
                         f"least one hidden layer; got {len(weights)} tensors")
    if x.dim() != 2:
        raise ValueError(f"x must be (P, d_in); got shape {tuple(x.shape)}")
    D = int(weights[0].shape[0]) if weights[0].dim() == 3 else 0
    dims = [int(x.shape[1])]
    for l in range(len(weights) // 2):
        W, b = weights[2 * l], weights[2 * l + 1]
        if (W.dim() != 3 or W.shape[0] != D or W.shape[2] != dims[-1]
                or b.shape != (D, W.shape[1])):
            raise ValueError(
                f"layer {l}: W {tuple(W.shape)} / b {tuple(b.shape)} are not D = {D} stacked "
                f"layers continuing width {dims[-1]} (W is (D, out, in), b is (D, out))")
        dims.append(int(W.shape[1]))
    if D < 1 or dims[-1] != 1:
        raise ValueError(f"need D >= 1 slots and one output; got D = {D}, {dims[-1]} outputs")
    known = _BATCHED_DIMS[key] = (tuple(dims), D)
    return known


def _stashed(t: torch.Tensor, stash: str) -> torch.Tensor:
    """``t`` as the stash keeps it: float32, or bf16 (rounded to nearest
    even) read back as float32."""
    return t.to(torch.bfloat16).to(t.dtype) if stash == "bf16" else t


@torch.no_grad()
def siren_loss_grads_batched_ref(x, weights, target, omega=30.0, n_rows=None, acts=None,
                                 sample_weights=None, stash="f32"):
    """Plain batched K1: ``(loss (D,), grads)`` of D stacked MLPs on one x,
    slot s being :func:`siren_loss_grads_ref` of ``[w[s] for w in weights]``,
    ``target[s]`` and ``sample_weights[s]`` (``target``, ``sample_weights``
    (D, P, 1)); the grads stacked as ``weights``. The batch is written out
    as ``einsum``/``bmm`` over the stacked weights.

    ``stash`` is what the backward keeps of the forward. ``"f32"`` (the
    default, what the CPU pipelines run): float32, plain autodiff's numbers.
    ``"bf16"``: the Pallas K1's stash (``siren_kernel.py:196-199, :289,
    :309, :319`` of the JAX package) and ``csrc/siren_wg.cu``'s: each
    layer's input enters dW as ``bf16(a)``, and a sine's factor is ``omega *
    f32(bf16(cos(omega z)))``; the forward, the chain and db stay float32."""
    if stash not in ("f32", "bf16"):
        raise ValueError(f"stash is 'f32' or 'bf16'; got {stash!r}")
    P = x.shape[0]
    n = len(weights) // 2
    n_rows = P if n_rows is None else int(n_rows)
    inv_n = 1.0 / (n_rows * target.shape[-1])
    acts = _acts(acts, n)
    omegas = _omegas(omega, n - 1)
    # forward, keeping each layer's input and its factor act'(z)
    inputs, factors, h = [x], [], x
    for l in range(n):
        z = _stacked_linear(h, weights[2 * l], weights[2 * l + 1])
        if l == n - 1:
            break
        if acts[l] == "sine":
            z = omegas[l] * z
            h = torch.sin(z)
            factors.append(omegas[l] * _stashed(torch.cos(z), stash))
        elif acts[l] == "relu":
            h = torch.relu(z)
            factors.append((z > 0).to(z.dtype))
        else:
            h = z
            factors.append(None)
        inputs.append(h)
    out = _act(z, acts[-1], 1.0)
    real = torch.arange(P, device=x.device)[None, :, None] < n_rows
    r = torch.where(real, out - target, torch.zeros_like(out))
    wr = r if sample_weights is None else sample_weights * r
    loss = (wr * r).sum(dim=(1, 2)) * inv_n
    delta = (2.0 * inv_n) * wr
    if acts[-1] == "relu":
        delta = delta * (z > 0).to(z.dtype)
    grads = [None] * len(weights)
    for l in reversed(range(n)):
        a = _stashed(inputs[l], stash)
        grads[2 * l] = (torch.einsum("dpo,pi->doi", delta, a) if a.dim() == 2
                        else torch.bmm(delta.transpose(1, 2), a))
        grads[2 * l + 1] = delta.sum(1)
        if l > 0:
            delta = torch.bmm(delta, weights[2 * l])
            if factors[l - 1] is not None:
                delta = delta * factors[l - 1]
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


def _wg_declare(lib: ctypes.CDLL) -> None:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.siren_wg_workspace_bytes.argtypes = [i, p, i, i]
    lib.siren_wg_workspace_bytes.restype = ll
    lib.siren_loss_grads_wg.argtypes = [p, i, i, p, i, i, p, p, p, p, p, p, f, p, p, p, ll, p, p]
    lib.siren_loss_grads_wg.restype = i
    lib.siren_loss_grads_wg_f32_workspace_bytes.argtypes = [i, p, i]
    lib.siren_loss_grads_wg_f32_workspace_bytes.restype = ll
    lib.siren_loss_grads_wg_f32.argtypes = [p, i, i, p, i, p, p, p, p, f, p, p, p, p, p]
    lib.siren_loss_grads_wg_f32.restype = i
    lib.siren_forward_wg_workspace_bytes.argtypes = [i, p, i]
    lib.siren_forward_wg_workspace_bytes.restype = ll
    lib.siren_forward_wg.argtypes = [p, i, p, i, p, p, p, p, p, p]
    lib.siren_forward_wg.restype = i
    lib.siren_fused_bwd_wg_workspace_bytes.argtypes = [i, p, i, i]
    lib.siren_fused_bwd_wg_workspace_bytes.restype = ll
    lib.siren_fused_bwd_wg.argtypes = [p, i, p, i, p, p, p, p, p, p, p, p, p]
    lib.siren_fused_bwd_wg.restype = i


def _wg_lib() -> ctypes.CDLL:
    return _build.library("siren_wg", _wg_declare)


def _rtc_declare(lib: ctypes.CDLL) -> None:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.siren_rtc_smem_bytes.argtypes = [p, i]
    lib.siren_rtc_smem_bytes.restype = ll
    lib.siren_rtc_setup.argtypes = []
    lib.siren_rtc_setup.restype = i
    lib.siren_rtc_work_floats.argtypes = [i, p, i, i, i]
    lib.siren_rtc_work_floats.restype = ll
    lib.siren_loss_grads_rtc.argtypes = [p, i, i, p, i, i, p, p, f, p, p, f, i, p, p, p, ll, p]
    lib.siren_loss_grads_rtc.restype = i


def _rtc_lib() -> ctypes.CDLL:
    return _build.library("siren_resident_tc", _rtc_declare)


_SMS: dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    """SMs of a CUDA device, asked once a device; 132 (an H100's) for the
    CPU, where the CUDA emulation of the tests runs the kernels."""
    if device.type != "cuda":
        return 132
    index = device.index if device.index is not None else torch.cuda.current_device()
    sms = _SMS.get(index)
    if sms is None:
        sms = _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return sms


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


def _n_params(dims: Sequence[int]) -> int:
    return sum(dims[l + 1] * (dims[l] + 1) for l in range(len(dims) - 1))


def _param_views(dims: Sequence[int], D: int | None = None, row: int | None = None) -> list:
    """Each of ``[dW0, db0, dW1, db1, ...]``'s (shape, stride, offset) in one
    buffer that holds them one after another in that order, for
    ``Tensor.as_strided``: (out, in) and (out,), or, given ``D``, with a
    leading slot axis of ``D`` slots ``row`` floats apart."""
    views, at = [], 0
    for l in range(len(dims) - 1):
        for shape, stride in (((dims[l + 1], dims[l]), (dims[l], 1)), ((dims[l + 1],), (1,))):
            views.append((shape, stride, at) if D is None else ((D, *shape), (row, *stride), at))
            at += math.prod(shape)
    return views


def _slot_strides(weights: Sequence[torch.Tensor]) -> tuple[int, ...]:
    """The floats between two slots' copies of each stacked tensor (the
    kernels read slot s of tensor i at its slot 0 + s stride); each slot's
    copy must be contiguous (from the strides alone: no view)."""
    strides = []
    for w in weights:
        stride, want = w.stride(), 1
        for d in range(w.dim() - 1, 0, -1):
            if w.shape[d] != 1 and stride[d] != want:
                raise ValueError("each slot of a stacked weight must be contiguous")
            want *= w.shape[d]
        strides.append(int(stride[0]))
    return tuple(strides)


# The SIREN sources' entries, each named by its C launch function: its
# workspace query (bytes, or floats where the query's name ends so; None:
# no workspace), whether it takes the activation codes, whether it takes the
# weights' (and the grads', and the slot strides') pointers as a W array and
# a b array (else one [W0, b0, W1, b1, ...] array), and the floats that
# follow the grads in a slot of its output buffer (the loss, max |out|).
_ENTRIES = {
    "siren_forward_f32": (None, True, True, 0),
    "siren_loss_grads_f32": ("siren_partial_floats", True, True, 2),
    "siren_fused_bwd_f32": ("siren_partial_floats", True, True, 0),
    "siren_loss_grads_stream": ("siren_stream_work_floats", True, False, 2),
    "siren_loss_grads_wg_f32": ("siren_loss_grads_wg_f32_workspace_bytes", False, True, 1),
    "siren_forward_wg": ("siren_forward_wg_workspace_bytes", False, True, 0),
    "siren_fused_bwd_wg": ("siren_fused_bwd_wg_workspace_bytes", False, True, 0),
    "siren_loss_grads_wg": ("siren_wg_workspace_bytes", False, True, 0),
    "siren_loss_grads_rtc": ("siren_rtc_work_floats", False, False, 1),
}


class _Plan:
    """The call plan of one entry of :data:`_ENTRIES` at one key of
    :func:`_plan`, built once: the ctypes arrays of the widths, the omegas,
    the activation codes and the slot strides; the arrays of the weights'
    and the grads' pointers (and of the SIMT route's stash), which each call
    fills in; the workspace's bytes from the source's own query, which
    refuses widths the source does not take; the source's one-time setup
    where it has one; and each grad's place in a slot of the call's output
    buffer. Called, a plan runs its entry inside the ``kernel.launch`` span
    and raises on a failed launch."""

    def __init__(self, lib, entry: str, P: int, dims: tuple, D: int, strides: tuple,
                 omegas: tuple, codes: tuple, extra: tuple, device: torch.device):
        query, _, self.split, tail = _ENTRIES[entry]
        L = self.L = len(dims) - 1
        # the plan holds its library, so that no other library takes its id
        self._lib, self.entry, self.launch = lib, entry, getattr(lib, entry)
        self.P, self.D, self.hidden, self.width = P, D, dims[1:-1], max(dims[1:-1])
        # a split entry's arrays hold every W (dW, W's slot stride) first,
        # then every b; the others' [W0, b0, W1, b1, ...]
        self.order = ((*range(0, 2 * L, 2), *range(1, 2 * L, 2)) if self.split
                      else tuple(range(2 * L)))
        slot = [strides[i] for i in self.order] if strides else []
        self._arrays = ((ctypes.c_int * len(dims))(*dims), (ctypes.c_float * (L - 1))(*omegas),
                        (ctypes.c_int * L)(*codes), (ctypes.c_longlong * (2 * L))(*slot),
                        *((ctypes.c_void_p * (2 * L))() for _ in range(3)))
        (self.dims, self.omegas, self.codes, self.slot, self.w, self.dw,
         self.stash) = map(ctypes.addressof, self._arrays)
        self.b, self.db, self.b_slot = self.w + 8 * L, self.dw + 8 * L, self.slot + 8 * L
        self.facts = self.stash + 8 * (L - 1)
        n = 0 if query is None else int(getattr(lib, query)(
            P, self.dims, L, *((D,) if D else ()), *extra))
        if n < 0:
            raise ValueError(f"{entry} does not take widths {list(dims)}"
                             + (f" at D = {D}" if D else ""))
        self.work = 4 * n if query and query.endswith("floats") else n
        self.n_params = _n_params(dims)
        self.row = self.n_params + tail
        self.views = _param_views(dims, D or None, self.row)
        self.grad_at = [4 * self.views[i][2] for i in self.order]
        if entry == "siren_loss_grads_rtc":
            # the grid barrier's counter, zeroed here: every call leaves it
            # 0, so calls of a plan run in stream order, as launches on
            # PyTorch's current stream do; the kernel's shared-memory
            # attribute is set once a plan
            self.sync = torch.zeros(2, dtype=torch.int32, device=device)
            _build.raise_on(lib.siren_rtc_setup(), "siren_rtc_setup")

    def fill(self, weights, out: torch.Tensor | None = None) -> list[torch.Tensor] | None:
        """Point the call at ``weights`` and, given its output buffer, at
        the grads in it, which it returns as views of ``out``."""
        self._arrays[4][:] = [weights[i].data_ptr() for i in self.order]
        if out is None:
            return None
        if self.split:
            base = out.data_ptr()
            self._arrays[5][:] = [base + at for at in self.grad_at]
        return [out.as_strided(*v) for v in self.views]

    def simt_buffers(self, like: torch.Tensor) -> list[torch.Tensor]:
        """The SIMT route's buffers, allocated each call: each hidden
        layer's stash and factor (P, width), which the plan's stash arrays
        point at, then two delta buffers (P, the widest hidden width)."""
        stash = [torch.empty(self.P, d, dtype=like.dtype, device=like.device)
                 for d in self.hidden]
        stash += [torch.empty_like(t) for t in stash]
        self._arrays[6][:len(stash)] = [t.data_ptr() for t in stash]
        return stash + [torch.empty(self.P, self.width, dtype=like.dtype, device=like.device)
                        for _ in range(2)]

    def __call__(self, *args) -> None:
        with span("kernel.launch"):
            rc = self.launch(*args)
        _build.raise_on(rc, self.entry)


_PLANS: dict[tuple, _Plan] = {}


def _plan(lib, entry: str, x: torch.Tensor, weights, omega, acts=None,
          extra: tuple = ()) -> _Plan:
    """The plan of ``entry`` on ``lib`` for a call, built at its key's first
    call. The key: the entry, the library, the device, P, the widths, D and
    the weights' strides (stacked weights, each W (D, out, in)), the
    omegas, the activation codes (of the entries that take them) and the
    ``extra`` arguments of the workspace query."""
    n = len(weights) // 2
    dims = (int(x.shape[1]),) + tuple(int(w.shape[-2]) for w in weights[0::2])
    stacked = weights[0].dim() == 3
    D = int(weights[0].shape[0]) if stacked else 0
    strides = tuple(w.stride() for w in weights) if stacked else ()
    codes = tuple(ACT_CODES[a] for a in _acts(acts, n)) if _ENTRIES[entry][1] else ()
    omegas = tuple(_omegas(omega, n - 1))
    key = (entry, id(lib), x.device, int(x.shape[0]), dims, D, strides, omegas, codes, extra)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _Plan(lib, entry, key[3], dims, D,
                                   _slot_strides(weights) if stacked else (), omegas, codes,
                                   extra, x.device)
    return plan


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _launch_forward(lib, x, weights, omega, stream, acts=None) -> torch.Tensor:
    """K3 on the SIMT route (``csrc/siren.cu``)."""
    plan = _plan(lib, "siren_forward_f32", x, weights, omega, acts)
    plan.fill(weights)
    out = torch.empty(plan.P, 1, dtype=x.dtype, device=x.device)
    buf = [torch.empty(plan.P, plan.width, dtype=x.dtype, device=x.device) for _ in range(2)]
    plan(x.data_ptr(), plan.P, plan.dims, plan.L, plan.codes, plan.w, plan.b, plan.omegas,
         out.data_ptr(), buf[0].data_ptr(), buf[1].data_ptr(), stream)
    return out


def _launch_loss_grads(lib, x, weights, target, omega, n_rows, stream, acts=None,
                       sample_weights=None, with_out_absmax=False):
    """K1 on the SIMT route (``csrc/siren.cu``, any widths): the loss, max
    |out| and grads are views of one buffer that the call allocates."""
    plan = _plan(lib, "siren_loss_grads_f32", x, weights, omega, acts)
    bufs = plan.simt_buffers(x)
    work = torch.empty(plan.work, dtype=torch.uint8, device=x.device)
    out = torch.empty(plan.row, dtype=x.dtype, device=x.device)
    grads = plan.fill(weights, out)
    n = plan.n_params
    inv_n = 1.0 / (n_rows * target.shape[-1])
    plan(x.data_ptr(), plan.P, int(n_rows), plan.dims, plan.L, plan.codes, plan.w, plan.b,
         plan.omegas, target.data_ptr(), _ptr(sample_weights), inv_n, plan.stash, plan.facts,
         bufs[-2].data_ptr(), bufs[-1].data_ptr(), work.data_ptr(), plan.dw, plan.db,
         out.data_ptr() + 4 * n, out.data_ptr() + 4 * (n + 1) if with_out_absmax else None,
         stream)
    return (out[n], out[n + 1], grads) if with_out_absmax else (out[n], grads)


def _launch_fused_bwd(lib, x, weights, g, omega, need_dw, need_dx, stream, acts=None):
    """K2 on the SIMT route (``csrc/siren.cu``); with dW the grads are views
    of one buffer."""
    plan = _plan(lib, "siren_fused_bwd_f32", x, weights, omega, acts)
    bufs = plan.simt_buffers(x)
    work = torch.empty(plan.work, dtype=torch.uint8, device=x.device)
    grads = plan.fill(weights, torch.empty(plan.row, dtype=x.dtype, device=x.device)
                      if need_dw else None)
    dx = torch.empty_like(x) if need_dx else None
    plan(x.data_ptr(), plan.P, plan.dims, plan.L, plan.codes, plan.w, plan.b, plan.omegas,
         g.data_ptr(), plan.stash, plan.facts, bufs[-2].data_ptr(), bufs[-1].data_ptr(),
         work.data_ptr(), plan.dw if need_dw else None, plan.db if need_dw else None,
         _ptr(dx), stream)
    return dx, grads


def _launch_loss_grads_wg_f32(lib, x, weights, target, omega, n_rows, stream):
    """K1 on the tensor-core route (the shapes :func:`tc_route` takes):
    ``csrc/siren_wg.cu``'s passes at one slot with the float32 stash. The
    loss and grads are views of one buffer that the call allocates."""
    plan = _plan(lib, "siren_loss_grads_wg_f32", x, weights, omega)
    work = torch.empty(plan.work, dtype=torch.uint8, device=x.device)
    out = torch.empty(plan.row, dtype=x.dtype, device=x.device)
    grads = plan.fill(weights, out)
    n = plan.n_params
    inv_n = 1.0 / (n_rows * target.shape[-1])
    plan(x.data_ptr(), plan.P, int(n_rows), plan.dims, plan.L, plan.w, plan.b, plan.omegas,
         target.data_ptr(), inv_n, work.data_ptr(), plan.dw, plan.db, out.data_ptr() + 4 * n,
         stream)
    return out[n], grads


def _launch_loss_grads_slots(route, lib, x, weights, target, omega, n_rows, stream, acts=None,
                             sample_weights=None, with_out_absmax=False):
    """K1 on a route whose blocks sum per-block slots (``route``:
    ``"stream"``, ``csrc/siren_stream.cu``, the widths :func:`stream_route`
    takes): one workspace and one output buffer a call, whose views are the
    returned loss, max |out| and grads."""
    plan = _plan(lib, f"siren_loss_grads_{route}", x, weights, omega, acts)
    work = torch.empty(plan.work, dtype=torch.uint8, device=x.device)
    out = torch.empty(plan.row, dtype=x.dtype, device=x.device)
    grads = plan.fill(weights, out)
    n = plan.n_params
    inv_n = 1.0 / (n_rows * target.shape[-1])
    plan(x.data_ptr(), plan.P, int(n_rows), plan.dims, plan.L, plan.codes, plan.w, plan.omegas,
         target.data_ptr(), _ptr(sample_weights), inv_n, work.data_ptr(), out.data_ptr(), stream)
    return (out[n], out[n + 1], grads) if with_out_absmax else (out[n], grads)


def _launch_loss_grads_wg(lib, x, weights, target, omega, n_rows, stream):
    """Batched K1 on the tensor-core route (``csrc/siren_wg.cu``'s
    ``siren_loss_grads_wg``): ``(loss (D,), grads)``, the grads views of one
    (D, n_params) buffer."""
    plan = _plan(lib, "siren_loss_grads_wg", x, weights, omega)
    work = torch.empty(plan.work, dtype=torch.uint8, device=x.device)
    buf = torch.empty(plan.D, plan.row, dtype=x.dtype, device=x.device)
    grads = plan.fill(weights, buf)
    loss = torch.empty(plan.D, dtype=x.dtype, device=x.device)
    inv_n = 1.0 / (n_rows * target.shape[-1])
    plan(x.data_ptr(), plan.P, int(n_rows), plan.dims, plan.L, plan.D, plan.w, plan.b,
         plan.slot, plan.b_slot, plan.omegas, target.data_ptr(), inv_n, work.data_ptr(),
         plan.dw, plan.db, plan.row, loss.data_ptr(), stream)
    return loss, grads


def _launch_loss_grads_resident_tc(lib, x, weights, target, omega, n_rows, stream,
                                   sample_weights=None):
    """The batched K1-w (``csrc/siren_resident_tc.cu``, the widths
    :func:`resident_tc_route` takes): ``(loss (D,), grads)``, views of one
    (D, n_params + 1) buffer whose row s holds slot s's grads, then its
    loss; one plan a shape, device, SM count and set of slot strides."""
    omega = float(omega if isinstance(omega, (int, float)) else omega[0])
    sms = _sm_count(x.device)
    plan = _plan(lib, "siren_loss_grads_rtc", x, weights, omega, extra=(sms,))
    work = torch.empty(plan.work, dtype=torch.uint8, device=x.device)
    out = torch.empty(plan.D, plan.row, dtype=x.dtype, device=x.device)
    grads = plan.fill(weights, out)
    inv_n = 1.0 / (n_rows * target.shape[-1])
    plan(x.data_ptr(), plan.P, int(n_rows), plan.dims, plan.L, plan.D, plan.w, plan.slot, omega,
         target.data_ptr(), _ptr(sample_weights), inv_n, sms, work.data_ptr(),
         plan.sync.data_ptr(), out.data_ptr(), plan.row, stream)
    return out[:, plan.n_params], grads


def _launch_forward_wg(lib, x, weights, omega, stream) -> torch.Tensor:
    """K3 on the tensor-core route (the shapes :func:`tc_route` takes)."""
    plan = _plan(lib, "siren_forward_wg", x, weights, omega)
    plan.fill(weights)
    work = torch.empty(plan.work, dtype=torch.uint8, device=x.device)
    out = torch.empty(plan.P, 1, dtype=x.dtype, device=x.device)
    plan(x.data_ptr(), plan.P, plan.dims, plan.L, plan.w, plan.b, plan.omegas, work.data_ptr(),
         out.data_ptr(), stream)
    return out


def _launch_fused_bwd_wg(lib, x, weights, g, omega, need_dw, need_dx, stream):
    """K2 on the tensor-core route (the shapes :func:`tc_route` takes), the
    float32 stash; with dW the grads are views of one buffer."""
    plan = _plan(lib, "siren_fused_bwd_wg", x, weights, omega, extra=(int(need_dw),))
    work = torch.empty(plan.work, dtype=torch.uint8, device=x.device)
    grads = plan.fill(weights, torch.empty(plan.row, dtype=x.dtype, device=x.device)
                      if need_dw else None)
    dx = torch.empty_like(x) if need_dx else None
    plan(x.data_ptr(), plan.P, plan.dims, plan.L, plan.w, plan.b, plan.omegas, g.data_ptr(),
         work.data_ptr(), plan.dw if need_dw else None, plan.db if need_dw else None, _ptr(dx),
         stream)
    return dx, grads


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


@span("kernel.siren_forward")
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
        out = _launch_forward_wg(_wg_lib(), x, weights, omega, _build.stream_ptr())
        LAUNCHES["siren_forward_wg"] += 1
        return out
    out = _launch_forward(_lib(), x, weights, omega, _build.stream_ptr(), acts)
    LAUNCHES["siren_forward"] += 1
    return out


@span("kernel.siren_loss_grads")
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
    card the loss, max |out| and grads are views of one buffer that the
    call allocates."""
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
    if route == "wg":
        out = _launch_loss_grads_wg_f32(_wg_lib(), x, weights, target, omega, n_rows,
                                        _build.stream_ptr())
    elif route == "stream":
        out = _launch_loss_grads_slots("stream", _stream_lib(), x, weights, target, omega,
                                       n_rows, _build.stream_ptr(), acts, sample_weights,
                                       with_out_absmax)
    else:
        out = _launch_loss_grads(_lib(), x, weights, target, omega, n_rows,
                                 _build.stream_ptr(), acts, sample_weights, with_out_absmax)
    LAUNCHES[loss_grads_key(weighted, with_out_absmax, route)] += 1
    return out


@span("kernel.siren_loss_grads_batched")
def siren_loss_grads_batched(x: torch.Tensor, weights: Sequence[torch.Tensor],
                             target: torch.Tensor, omega: float | Sequence[float] = 30.0,
                             n_rows: int | None = None, acts: Sequence[str] | None = None,
                             sample_weights: torch.Tensor | None = None):
    """Batched K1, the counterpart of ``jax.vmap`` over ``siren_loss_grads``:
    ``(loss (D,), grads)`` of D stacked MLPs on one shared ``x`` (P, d_in).
    ``weights`` is the flat list with a leading slot axis, each W (D, out,
    in) and b (D, out) (each slot's copy contiguous; the slots may lie any
    stride apart, as views of one parameter buffer do); ``target`` and
    ``sample_weights`` are (D, P, 1); the grads are stacked like ``weights``.
    Slot s is :func:`siren_loss_grads` of slot s's inputs.

    On the card the route follows from the shapes (:func:`batched_route`):
    the tensor-core class (the hybrid fit's 256 -> 512x4 -> 1) and the 2-D
    ensemble's class (d0 -> 64 x NH -> 1, sine with one omega; the ensemble
    runs it with sample weights) have batched kernels, one launch a call for
    the D slots: ``csrc/siren_wg.cu`` (``wgmma`` fed by TMA, the Pallas K1's
    bf16 stash: :func:`siren_loss_grads_batched_ref` with ``stash="bf16"``;
    counted under ``siren_loss_grads_wg_batched``) and
    ``csrc/siren_resident_tc.cu`` (``mma.sync`` bf16x3 products, the float32
    stash; counted under
    ``siren_loss_grads_[weighted_]resident_tc_batched``). Their grads are
    views of one (D, n_params [+ 1]) buffer, the loss in the last column on
    the second. Every other call (ReLU codes or per-layer omegas at the 2-D
    ensemble's widths, the streaming and SIMT widths) runs the slots in turn
    through :func:`siren_loss_grads`, counted under its keys.

    The checks are lean, as the 2-D ensemble calls this 27,000 times a
    case: each tensor's type and device once, the slots' contiguity from
    the strides, the widths once a shape."""
    weights = list(weights)
    dims, D = _batched_dims(x, weights)
    acts = _acts(acts, len(weights) // 2)
    P = x.shape[0]
    if target.shape != (D, P, 1):
        raise ValueError(f"target must be ({D}, {P}, 1); got {tuple(target.shape)}")
    if sample_weights is not None and sample_weights.shape != (D, P, 1):
        raise ValueError(f"sample_weights must be ({D}, {P}, 1); got "
                         f"{tuple(sample_weights.shape)}")
    n_rows = P if n_rows is None else int(n_rows)
    if not 0 < n_rows <= P:
        raise ValueError(f"n_rows {n_rows} outside (0, {P}]")
    extra = [] if sample_weights is None else [sample_weights]
    dev = _build.check_tensors("SIREN", x, [target, *extra], (torch.float32,))
    for w in weights:
        if w.dtype != torch.float32:
            raise TypeError(f"SIREN kernels take torch.float32; got {w.dtype}")
        if w.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}; got one on {w.device}")
    if dev == "cpu":
        _slot_strides(weights)
        return siren_loss_grads_batched_ref(x, weights, target, omega, n_rows, acts,
                                            sample_weights)
    weighted = sample_weights is not None
    route = batched_route(dims, acts, omega, weighted)
    if route == "wg":
        out = _launch_loss_grads_wg(_wg_lib(), x, weights, target, omega, n_rows,
                                    _build.stream_ptr())
        LAUNCHES["siren_loss_grads_wg_batched"] += 1
        return out
    if route == "resident_tc":
        out = _launch_loss_grads_resident_tc(_rtc_lib(), x, weights, target, omega, n_rows,
                                             _build.stream_ptr(), sample_weights)
        LAUNCHES[loss_grads_key(weighted, False, "resident_tc") + "_batched"] += 1
        return out
    slots = [siren_loss_grads(x, [w[s] for w in weights], target[s], omega, n_rows, acts,
                              None if sample_weights is None else sample_weights[s])
             for s in range(D)]
    return (torch.stack([loss for loss, _ in slots]),
            [torch.stack(g) for g in zip(*(grads for _, grads in slots))])


@span("kernel.siren_fused_bwd")
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
        out = _launch_fused_bwd_wg(_wg_lib(), x, weights, g, omega, need_dw, need_dx,
                                   _build.stream_ptr())
        LAUNCHES["siren_fused_bwd_wg"] += 1
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


def make_fused_value_and_grad(model):
    """``vag(params, x, target, n_rows=None) -> (loss, grads)``: the MSE
    gradient of a plain Siren in one K1 pass
    (``make_fused_value_and_grad`` of the JAX package; the kernel takes any
    width, so no padding; ``n_rows``: the loss and gradient of the first
    rows alone). At the tensor-core route's widths (multiples of
    :data:`TC_TILE`, the flagship 256 -> 512xN -> 1) it runs there.
    ``params`` in ``model.weights()`` order."""
    omega, acts = _model_omega_acts(model)

    def vag(params, x, target, n_rows=None):
        return siren_loss_grads(x, params, target, omega, n_rows=n_rows, acts=acts)

    return vag


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


def make_fused_value_and_grad_batched(model):
    """``vag(params, x, targets, n_rows=None) -> (loss (D,), grads)``: the
    MSE gradients of D stacked plain Sirens of ``model``'s widths in one
    batched K1 call (:func:`siren_loss_grads_batched`; ``jax.vmap`` of
    ``make_fused_value_and_grad``'s adapter in the JAX package). ``params``
    stacked in ``model.weights()`` order, ``targets`` (D, P, 1)."""
    omega, acts = _model_omega_acts(model)

    def vag(params, x, targets, n_rows=None):
        return siren_loss_grads_batched(x, params, targets, omega, n_rows=n_rows, acts=acts)

    return vag


def make_fused_weighted_value_and_grad_batched(model):
    """``vag(params, x, targets, sample_weights) -> (loss (D,), grads)``:
    the acceptance-weighted MSE of D stacked Sirens of ``model``'s widths in
    one batched K1 call (``jax.vmap`` of
    ``make_fused_weighted_value_and_grad``'s adapter, as the JAX package's
    2-D ensemble runs it over its directions). ``params`` stacked in
    ``model.weights()`` order, ``targets`` and ``sample_weights`` (D, P,
    1)."""
    omega, acts = _model_omega_acts(model)

    def vag(params, x, targets, sample_weights):
        return siren_loss_grads_batched(x, params, targets, omega, acts=acts,
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
