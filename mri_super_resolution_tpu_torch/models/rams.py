"""RAMS: residual attention multi-image super-resolution network.

Counterpart of ``mri_super_resolution_tpu/models/rams.py`` (reference:
multi-image-super-resolution/utils/network.py:18-155). For scale 3 and T = 9
acquisitions:

    normalize -> (B, H, W, T, 1) -> reflect-pad H, W -> WN-Conv3D -> N x RFAB
    -> WN-Conv3D + long skip -> T // 3 x [reflect-pad H, W -> RFAB -> VALID
    WN-Conv3D, ReLU] (T 9 -> 7 -> 5 -> 3) -> VALID WN-Conv3D to scale^2
    channels -> drop T -> depth_to_space; plus the global 2-D path on the
    raw T-channel image: reflect-pad -> RTAB -> VALID WN-Conv2D(scale^2) ->
    depth_to_space; sum in float32; denormalize.

The JAX package's layout holds at the public interface: input ``(B, H, W,
T)``, 5-D activations ``(B, H, W, T, C)``, weight-norm directions ``v`` of
shape ``(kh, kw, kt, Cin, Cout)`` (2-D: ``(kh, kw, Cin, Cout)``), so
``convert.rams_state_dict`` only renames. Activations run in
``compute_dtype``; the parameters, the attention gates' pooled features and
the final sum stay float32.

Convolutions: with ``conv_kernel=True`` a 3x3x3 SAME or VALID conv whose
channel counts are multiples of 8 runs K6 (``ops/conv3d_kernel.py``: float32
sums, the float32 bias added, one rounding); every other conv goes to
``F.conv3d`` / ``F.conv2d`` in the compute type with the bias added in that
type, as the JAX package's XLA route does.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mri_super_resolution_tpu_torch.ops.conv3d_kernel import conv3d_rfab

MEAN = 7433.6436  # PROBA-V dataset statistics (network.py:18-19)
STD = 2353.0723


def normalize(x: torch.Tensor, mean: float = MEAN, std: float = STD) -> torch.Tensor:
    return (x - mean) / std


def denormalize(x: torch.Tensor, mean: float = MEAN, std: float = STD) -> torch.Tensor:
    return x * std + mean


def depth_to_space(x: torch.Tensor, block: int) -> torch.Tensor:
    """``tf.nn.depth_to_space`` for (B, H, W, C): channel ``(by * block + bx)
    * c + k`` goes to pixel offset (by, bx), channel k. This is TF's order,
    not ``torch.pixel_shuffle``'s ``(c, block, block)``."""
    B, H, W, C = x.shape
    c = C // (block * block)
    x = x.reshape(B, H, W, block, block, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H * block, W * block, c)


def reflect_pad_hw(x: torch.Tensor, pad: int = 1, axes: Sequence[int] = (1, 2)) -> torch.Tensor:
    """Reflective padding (edge not repeated) of ``pad`` on each of ``axes``
    (network.py:37-39)."""
    for a in axes:
        n = x.shape[a]
        idx = torch.cat([torch.arange(pad, 0, -1), torch.arange(n),
                         torch.arange(n - 2, n - 2 - pad, -1)]).to(x.device)
        x = x.index_select(a, idx)
    return x


def weight_norm_kernel(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Effective kernel ``g * v / ||v||``, the norm over all but the output
    axis."""
    v2 = v.reshape(-1, v.shape[-1])
    n = torch.sqrt((v2 * v2).sum(0) + 1e-12)
    return (v2 * (g / n)).reshape(v.shape)


def _library_conv(x: torch.Tensor, kernel: torch.Tensor, padding: str) -> torch.Tensor:
    """Channels-last N-D conv through ``F.conv2d`` / ``F.conv3d``."""
    nd = kernel.dim() - 2
    conv = F.conv3d if nd == 3 else F.conv2d
    to_first = (0, nd + 1, *range(1, nd + 1))
    w = kernel.permute(nd + 1, nd, *range(nd))  # (Cout, Cin, k...)
    out = conv(x.permute(*to_first), w, padding=padding.lower())
    return out.permute(0, *range(2, nd + 2), 1)


class WNConv(nn.Module):
    """Weight-normalised N-D convolution (tfa WeightNormalization with
    ``data_init=False``): ``v`` glorot-uniform, ``g`` ones, ``bias`` zeros;
    the effective kernel ``g * v / ||v||`` is formed on every call."""

    def __init__(self, in_ch: int, features: int, kernel_size: Sequence[int],
                 padding: str = "SAME", conv_kernel: bool = False, device=None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.padding = padding
        kshape = (*self.kernel_size, in_ch, features)
        self.v = nn.Parameter(torch.empty(kshape, device=device))
        self.g = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        # the gate of models/rams.py:123-128: lane-aligned 3x3x3 convs only
        self.use_k6 = (conv_kernel and self.kernel_size == (3, 3, 3)
                       and padding in ("SAME", "VALID")
                       and in_ch % 8 == 0 and features % 8 == 0)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """flax ``glorot_uniform`` for ``v``, ones for ``g``, zeros for the bias."""
        receptive = math.prod(self.kernel_size)
        fan_in, fan_out = self.v.shape[-2] * receptive, self.v.shape[-1] * receptive
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(self.v.shape, generator=generator)
        self.v.copy_((2.0 * u - 1.0) * limit)
        self.g.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = weight_norm_kernel(self.v, self.g)
        if self.use_k6:
            return conv3d_rfab(x, kernel, self.bias, self.padding)
        return _library_conv(x, kernel.to(x.dtype), self.padding) + self.bias.to(x.dtype)


class RFAB(nn.Module):
    """Residual Feature Attention Block (network.py:42-63)."""

    def __init__(self, filters: int, kernel_size: int = 3, r: int = 8,
                 conv_kernel: bool = False, device=None):
        super().__init__()
        k = (kernel_size,) * 3
        self.conv0 = WNConv(filters, filters, k, conv_kernel=conv_kernel, device=device)
        self.conv1 = WNConv(filters, filters, k, conv_kernel=conv_kernel, device=device)
        self.att0 = WNConv(filters, filters // r, (1, 1, 1), device=device)
        self.att1 = WNConv(filters // r, filters, (1, 1, 1), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x
        x = self.conv1(torch.relu(self.conv0(x)))
        # channel attention; the pooled mean in float32, the gate cast back
        att = x.float().mean(dim=(1, 2, 3), keepdim=True)
        att = torch.sigmoid(self.att1(torch.relu(self.att0(att)))).to(x.dtype)
        return x * att + res


class RTAB(nn.Module):
    """Residual Temporal Attention Block, 2-D (network.py:65-87)."""

    def __init__(self, filters: int, kernel_size: int = 3, r: int = 8, device=None):
        super().__init__()
        k = (kernel_size,) * 2
        self.conv0 = WNConv(filters, filters, k, device=device)
        self.conv1 = WNConv(filters, filters, k, device=device)
        self.att0 = WNConv(filters, filters // r, (1, 1), device=device)
        self.att1 = WNConv(filters // r, filters, (1, 1), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x
        x = self.conv1(torch.relu(self.conv0(x)))
        att = x.float().mean(dim=(1, 2), keepdim=True)
        att = torch.sigmoid(self.att1(torch.relu(self.att0(att)))).to(x.dtype)
        return x * att + res


class RAMS(nn.Module):
    """The full RAMS network (network.py:91-155): (B, H, W, T) acquisitions
    in the uint16 range -> (B, scale H, scale W, 1). Parameters start at the
    flax initialisers, drawn from ``generator``."""

    def __init__(self, scale: int = 3, filters: int = 32, kernel_size: int = 3,
                 channels: int = 9, r: int = 8, N: int = 12, mean: float = MEAN,
                 std: float = STD, compute_dtype: str = "float32",
                 conv_kernel: bool = False, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.scale, self.mean, self.std = scale, mean, std
        self.compute_dtype = getattr(torch, compute_dtype)
        k3 = (kernel_size,) * 3
        ck = dict(conv_kernel=conv_kernel, device=device)
        self.head = WNConv(1, filters, k3, **ck)
        self.rfabs = nn.ModuleList(RFAB(filters, kernel_size, r, **ck) for _ in range(N))
        self.body_conv = WNConv(filters, filters, k3, **ck)
        # temporal reduction T -> T - 2 (T // 3), one RFAB + VALID conv per step
        self.reduce_rfabs = nn.ModuleList(RFAB(filters, kernel_size, r, **ck)
                                          for _ in range(channels // 3))
        self.reduce_convs = nn.ModuleList(WNConv(filters, filters, (3, 3, 3), "VALID", **ck)
                                          for _ in range(channels // 3))
        self.to_scale = WNConv(filters, scale ** 2, (3, 3, 3), "VALID", device=device)
        self.rtab = RTAB(channels, kernel_size, r, device=device)
        self.global_conv = WNConv(channels, scale ** 2, (3, 3), "VALID", device=device)
        for m in self.modules():
            if isinstance(m, WNConv):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = normalize(x, self.mean, self.std).to(self.compute_dtype)
        global_res = x  # (B, H, W, T)
        x = self.head(reflect_pad_hw(x[..., None]))
        res = x
        for blk in self.rfabs:
            x = blk(x)
        x = self.body_conv(x) + res
        for blk, conv in zip(self.reduce_rfabs, self.reduce_convs):
            x = torch.relu(conv(blk(reflect_pad_hw(x))))
        x = depth_to_space(self.to_scale(x).squeeze(3), self.scale)  # T is 1 here
        g = self.global_conv(self.rtab(reflect_pad_hw(global_res)))
        g = depth_to_space(g, self.scale)
        return denormalize(x.float() + g.float(), self.mean, self.std)


@torch.no_grad()
def fold_weight_norm(state_dict: dict) -> dict:
    """Fold the weight-norm reparametrisation into the kernels for serving:
    each ``(v, g)`` pair becomes ``(w, ||w||)`` with ``w = g v / ||v||``, so
    the per-call norm reproduces ``w`` (the keys are unchanged). Not for
    training: the gradients of ``v`` and ``g`` change meaning."""
    out = dict(state_dict)
    for key, v in state_dict.items():
        if not key.endswith(".v") or key[:-1] + "g" not in state_dict:
            continue
        gkey = key[:-1] + "g"
        w = weight_norm_kernel(torch.as_tensor(v, dtype=torch.float32),
                               torch.as_tensor(state_dict[gkey], dtype=torch.float32))
        w2 = w.reshape(-1, w.shape[-1])
        out[key] = w
        out[gkey] = torch.sqrt((w2 * w2).sum(0))
    return out
