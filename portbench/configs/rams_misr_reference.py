"""Plain reference of ``rams_misr_reference``: RAMS multi-image
super-resolution serving (multi-image-super-resolution/utils/network.py:18-155,
the network; master.py:29-68, a case's 25-draw predict), in float32 PyTorch.

Works everything out again from the benchmark's raw inputs: the flax-named
``v``, ``g`` and ``bias`` arrays of the checkpoint (``params/WNConv_0/v``,
...), a case's acquisition slice, its b0 slice and b-value, and a
request's seed. Its own, in order: the names of flax's call order, the
weight norm ``g v / ||v||``, reflect padding, ``F.conv3d`` / ``F.conv2d``
with zero SAME padding, the channel gates, depth_to_space in TF's order,
denormalize; then master.py's numpy draws, the clip to [0, 2^16], the
round, the mean over the draws, and the ADC against the b0 slice upscaled
bilinearly. It imports neither the program nor JAX.

Departures from network.py, all of them numerics: float32 throughout
(activations included), where the configuration serves bfloat16
activations with float32 parameters, gates and final sum; TF32 off, as the
harness sets it; activations are channels-first here, which changes no
value; the forward runs in blocks of draws, which changes no value either.
``precision="bf16_sums"`` is the control, below the configuration's
precision: bfloat16 activations, as the program keeps them, and each
convolution's sum over its taps kept in bfloat16 (the products over the
channels of one tap in float32).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MEAN = 7433.6436  # network.py:18-19, the training set's statistics
STD = 2353.0723
UINT16 = 2.0 ** 16
ADC_EPS = 1e-7  # master.py:55-56's two-point ADC
PRECISIONS = ("float32", "bf16_sums")


def _numbered(tree: dict, prefix: str) -> list[str]:
    return sorted((k for k in tree if k.startswith(prefix)), key=lambda k: int(k.split("_")[1]))


def _weight(leaf: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A weight-normalised conv's ``(w, bias)``: ``w = g v / ||v||``, the
    norm over every axis but the output one, as a channels-first
    ``(Cout, Cin, k...)`` kernel, float32 (the norm taken in float64)."""
    v = torch.as_tensor(np.asarray(leaf["v"]), dtype=torch.float64)
    g = torch.as_tensor(np.asarray(leaf["g"]), dtype=torch.float64)
    w = g * v / v.reshape(-1, v.shape[-1]).norm(dim=0)
    nd = w.dim() - 2
    w = w.permute(nd + 1, nd, *range(nd))
    b = torch.as_tensor(np.asarray(leaf["bias"]), dtype=torch.float32)
    return w.to(device, torch.float32).contiguous(), b.to(device)


def _block(tree: dict, device) -> list:
    """RFAB / RTAB: its ``WNConv_0..3`` are conv0, conv1 and the gate's two."""
    return [_weight(tree[f"WNConv_{i}"], device) for i in range(4)]


def network(flat: dict, device) -> dict:
    """The layers from the flat ``params/<module>/<leaf>`` arrays. flax names
    the modules in call order: ``WNConv_0`` the head, ``RFAB_0..N-1``,
    ``WNConv_1`` the body conv, per temporal step ``RFAB_{N+i}`` and
    ``WNConv_{2+i}``, then ``WNConv_{2+k}`` (to scale^2), ``RTAB_0`` and
    ``WNConv_{3+k}`` (the global conv), with k the temporal steps."""
    tree: dict = {}
    for key, arr in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    p = tree["params"]
    k = len(_numbered(p, "WNConv_")) - 4
    n = len(_numbered(p, "RFAB_")) - k
    return {
        "head": _weight(p["WNConv_0"], device),
        "rfabs": [_block(p[f"RFAB_{i}"], device) for i in range(n)],
        "body": _weight(p["WNConv_1"], device),
        "reduce": [(_block(p[f"RFAB_{n + i}"], device), _weight(p[f"WNConv_{2 + i}"], device))
                   for i in range(k)],
        "to_scale": _weight(p[f"WNConv_{2 + k}"], device),
        "rtab": _block(p["RTAB_0"], device),
        "global": _weight(p[f"WNConv_{3 + k}"], device),
    }


class _Numerics:
    """Where the control rounds: ``act`` an activation, ``conv`` a conv's
    sum over its taps."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.low = precision == "bf16_sums"

    def act(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.bfloat16).float() if self.low else t

    def conv(self, x: torch.Tensor, layer, same: bool) -> torch.Tensor:
        """Conv + bias on channels-first ``(B, C, spatial...)``; zero
        padding of 1 on every spatial axis when ``same``."""
        w, b = layer
        nd = w.dim() - 2
        if not self.low:
            conv = F.conv3d if nd == 3 else F.conv2d
            return conv(x, w, b, padding=1 if same and w.shape[-1] > 1 else 0)
        w = self.act(w)
        if same and w.shape[-1] > 1:
            x = F.pad(x, (1, 1) * nd)
        ks = w.shape[2:]
        out_sp = [x.shape[2 + a] - ks[a] + 1 for a in range(nd)]
        acc = None
        for tap in np.ndindex(*ks):
            sl = x[(slice(None), slice(None)) + tuple(slice(t, t + o) for t, o in zip(tap, out_sp))]
            part = torch.einsum("bc...,oc->bo...", sl, w[(slice(None), slice(None)) + tap])
            acc = self.act(part if acc is None else acc + part)
        return self.act(acc + b.reshape(1, -1, *([1] * nd)))


def _reflect(x: torch.Tensor) -> torch.Tensor:
    """Reflect-pad H and W by 1 (the edge not repeated; network.py:37-39);
    ``x`` is ``(B, C, H, W, T)`` or ``(B, C, H, W)``."""
    pad = (0, 0, 1, 1, 1, 1) if x.dim() == 5 else (1, 1, 1, 1)
    return F.pad(x, pad, mode="reflect")


def _attention(x: torch.Tensor, block: list, num: _Numerics) -> torch.Tensor:
    """RFAB (3-D) or RTAB (2-D): conv -> ReLU -> conv, times the channel
    gate (the mean over the spatial axes -> 1x1 conv -> ReLU -> 1x1 conv ->
    sigmoid, in float32), plus the skip (network.py:42-87)."""
    conv0, conv1, att0, att1 = block
    y = num.conv(num.act(torch.relu(num.conv(x, conv0, True))), conv1, True)
    pooled = y.mean(dim=tuple(range(2, y.dim())), keepdim=True)
    gate = num.act(torch.sigmoid(F.conv3d(torch.relu(F.conv3d(pooled, *att0)), *att1)
                                 if y.dim() == 5 else
                                 F.conv2d(torch.relu(F.conv2d(pooled, *att0)), *att1)))
    return num.act(num.act(y * gate) + x)


def depth_to_space(x: torch.Tensor, s: int) -> torch.Tensor:
    """TF's ``depth_to_space`` on channels-first ``(B, s*s*c, H, W)``: channel
    ``(by s + bx) c + k`` goes to pixel offset (by, bx) of channel k."""
    B, C, H, W = x.shape
    c = C // (s * s)
    return x.reshape(B, s, s, c, H, W).permute(0, 3, 4, 1, 5, 2).reshape(B, c, H * s, W * s)


@torch.no_grad()
def forward(net: dict, x: torch.Tensor, scale: int, precision: str = "float32") -> torch.Tensor:
    """RAMS on ``(B, H, W, T)`` acquisitions in the uint16 range ->
    ``(B, scale H, scale W)`` float32 (network.py:91-155)."""
    num = _Numerics(precision)
    x = num.act((x.float() - MEAN) / STD)
    raw = x.permute(0, 3, 1, 2)  # (B, T, H, W): the 2-D path's channels are T
    h = num.conv(_reflect(x[:, None]), net["head"], True)  # (B, F, H+2, W+2, T)
    skip = h
    for block in net["rfabs"]:
        h = _attention(h, block, num)
    h = num.act(num.conv(h, net["body"], True) + skip)
    for block, conv in net["reduce"]:
        h = num.act(torch.relu(num.conv(_attention(_reflect(h), block, num), conv, False)))
    local = depth_to_space(num.conv(h, net["to_scale"], False)[..., 0], scale)
    g = num.conv(_attention(_reflect(raw), net["rtab"], num), net["global"], False)
    return ((local + depth_to_space(g, scale)) * STD + MEAN)[:, 0]


def draws(num_acq: int, channels: int, sample_size: int, seed) -> list[np.ndarray]:
    """master.py:44-49's draws: per sample ``channels`` acquisitions, without
    replacement when there are enough, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [rng.choice(num_acq, size=channels, replace=num_acq < channels)
            for _ in range(sample_size)]


def upscale(img: np.ndarray, s: int) -> np.ndarray:
    """Bilinear upscaling by the integer ``s`` with half-pixel centres, the
    edge samples held (skimage's ``rescale`` at order 1, whose ``reflect``
    edge mode holds them): output pixel o reads input position
    ``(o + 0.5) / s - 0.5``, clamped to the image."""
    def weights(n: int) -> np.ndarray:
        pos = np.clip((np.arange(n * s) + 0.5) / s - 0.5, 0.0, n - 1)
        lo = np.floor(pos).astype(int)
        hi = np.minimum(lo + 1, n - 1)
        m = np.zeros((n * s, n))
        np.add.at(m, (np.arange(n * s), lo), 1.0 - (pos - lo))
        np.add.at(m, (np.arange(n * s), hi), pos - lo)
        return m

    return weights(img.shape[0]) @ img.astype(np.float64) @ weights(img.shape[1]).T


def predict_case(net: dict, dwi: np.ndarray, b0: np.ndarray, b: float, seed, channels: int,
                 sample_size: int, scale: int, device, precision: str = "float32",
                 block: int = 5) -> tuple[np.ndarray, np.ndarray]:
    """A case's ``(mean DWI, ADC)``, both ``(scale H, scale W)`` float64,
    from its ``(H, W, A)`` acquisition slice ``dwi`` and ``(H, W)`` b0
    slice: the draws scaled by 256 to the uint16 range, each predicted,
    clipped to [0, 2^16] and rounded, then averaged; the two-point ADC
    ``-log(mean / (b0 up + eps) + eps) / b * 1e6`` (master.py:38-57)."""
    lor = np.asarray(dwi, dtype=np.float32) * 256.0
    picks = draws(lor.shape[-1], channels, sample_size, seed)
    total = np.zeros((scale * lor.shape[0], scale * lor.shape[1]))
    for i in range(0, len(picks), block):
        x = torch.as_tensor(np.stack([lor[..., p] for p in picks[i:i + block]]), device=device)
        sr = forward(net, x, scale, precision).double().cpu().numpy()
        total += np.round(np.clip(sr, 0.0, UINT16)).sum(axis=0)
    mean = total / len(picks)
    up = upscale(np.asarray(b0, dtype=np.float64), scale)
    adc = -np.log(mean / (up + ADC_EPS) + ADC_EPS) / float(b) * 1e6
    return mean, adc
