"""SIREN coordinate MLP with the reference's initialisation.

Counterpart of ``mri_super_resolution_tpu/models/siren.py`` (``SineLayer``,
``Siren`` :100-136, inits :54-89): ``sin(omega_0 * (W x + b))`` with first
layer W ~ U(+-1/in), hidden and final W ~ U(+-sqrt(6/in)/omega_0), and every
bias at torch ``nn.Linear``'s U(+-1/sqrt(in)).
"""
from __future__ import annotations

import math

import torch
from torch import nn


def _linear(in_f: int, out_f: int, w_bound: float, generator, device) -> nn.Linear:
    layer = nn.Linear(in_f, out_f, device=device)
    with torch.no_grad():
        w = torch.empty(out_f, in_f).uniform_(-w_bound, w_bound, generator=generator)
        b_bound = 1.0 / math.sqrt(in_f)
        b = torch.empty(out_f).uniform_(-b_bound, b_bound, generator=generator)
        layer.weight.copy_(w)
        layer.bias.copy_(b)
    return layer


class SineLayer(nn.Module):
    """Linear + sin(omega_0 * .) with SIREN init."""

    def __init__(self, in_features: int, out_features: int, omega_0: float = 30.0,
                 is_first: bool = False, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.omega_0 = float(omega_0)
        bound = (1.0 / in_features if is_first
                 else math.sqrt(6.0 / in_features) / self.omega_0)
        self.linear = _linear(in_features, out_features, bound, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sin(self.omega_0 * self.linear(x))


class Siren(nn.Module):
    """First SineLayer, ``hidden_layers`` hidden SineLayers, final linear."""

    def __init__(self, in_features: int, hidden_features: int = 256,
                 hidden_layers: int = 3, out_features: int = 1,
                 first_omega_0: float = 30.0, hidden_omega_0: float = 30.0,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        layers = [SineLayer(in_features, hidden_features, first_omega_0, True,
                            generator, device)]
        layers += [SineLayer(hidden_features, hidden_features, hidden_omega_0, False,
                             generator, device) for _ in range(hidden_layers)]
        final = _linear(hidden_features, out_features,
                        math.sqrt(6.0 / hidden_features) / hidden_omega_0,
                        generator, device)
        self.net = nn.ModuleList([*layers, final])
        self.omegas = (float(first_omega_0),) + (float(hidden_omega_0),) * hidden_layers

    def weights(self) -> list[torch.Tensor]:
        """Parameters in the kernels' order ``[W0, b0, ..., W_last, b_last]``
        (``nn.Linear`` layout, W is (out, in))."""
        out = []
        for layer in self.net:
            lin = layer.linear if isinstance(layer, SineLayer) else layer
            out += [lin.weight, lin.bias]
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x
