"""PerturbNet: learned per-acquisition coordinate offset.

Counterpart of ``mri_super_resolution_tpu/models/perturbnet.py`` (:24-37):
``eps * tanh(L2(tanh(L1(concat(coords, acq / 10)))))``, both linears with
lecun-normal weights (truncated normal, std sqrt(1/in) / 0.8796...) and
U(+-1/sqrt(in)) biases.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

# std of a unit normal truncated to [-2, 2] (flax's lecun_normal divides by it)
_TRUNC_STD = 0.87962566103423978


def _lecun_linear(in_f: int, out_f: int, generator, device) -> nn.Linear:
    layer = nn.Linear(in_f, out_f, device=device)
    with torch.no_grad():
        std = math.sqrt(1.0 / in_f) / _TRUNC_STD
        w = torch.empty(out_f, in_f)
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        bound = 1.0 / math.sqrt(in_f)
        b = torch.empty(out_f).uniform_(-bound, bound, generator=generator)
        layer.weight.copy_(w)
        layer.bias.copy_(b)
    return layer


def perturbnet_apply(params: Sequence[torch.Tensor], coords: torch.Tensor,
                     sample: float = 0.0, eps: float = 0.0,
                     acq_scale: float = 10.0) -> torch.Tensor:
    """Functional PerturbNet over ``params = [W0, b0, W1, b1]``. The acq id is
    divided by ``acq_scale`` in the coordinates' dtype."""
    acq = torch.full((*coords.shape[:-1], 1), float(sample), dtype=coords.dtype,
                     device=coords.device) / acq_scale
    x = torch.cat([coords, acq], dim=-1)
    x = torch.tanh(x @ params[0].T + params[1])
    x = x @ params[2].T + params[3]
    return eps * torch.tanh(x)


class PerturbNet(nn.Module):
    def __init__(self, in_features: int, hidden_features: int = 128,
                 dimension: int = 2, acq_scale: float = 10.0,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.acq_scale = float(acq_scale)
        self.fc0 = _lecun_linear(in_features + 1, hidden_features, generator, device)
        self.fc1 = _lecun_linear(hidden_features, dimension, generator, device)

    def weights(self) -> list[torch.Tensor]:
        return [self.fc0.weight, self.fc0.bias, self.fc1.weight, self.fc1.bias]

    def forward(self, coords: torch.Tensor, sample: float = 0.0,
                eps: float = 0.0) -> torch.Tensor:
        return perturbnet_apply(self.weights(), coords, sample, eps, self.acq_scale)
