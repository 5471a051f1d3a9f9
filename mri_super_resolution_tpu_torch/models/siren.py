"""SIREN coordinate MLPs with the reference's initialisation.

Counterpart of ``mri_super_resolution_tpu/models/siren.py`` (``SineLayer``,
``Siren`` :100-136, ``PerturbHead`` and ``SirenERD`` :139-193, ``SirenToy``
:196-230, inits
:54-89): ``sin(omega_0 * (W x + b))`` with first layer W ~ U(+-1/in), hidden
and final W ~ U(+-sqrt(6/in)/omega_0), and every bias at torch
``nn.Linear``'s U(+-1/sqrt(in)). ``SirenERD``'s ReLU head and the
perturbation branches start from flax's ``lecun_normal`` (a normal of variance
1/in truncated at two standard deviations) where the JAX package uses it.

Each model's ``weights()`` lists its trunk in the kernels' order and
``acts`` names the trunk's activations (``ops/siren_kernel.py``).
"""
from __future__ import annotations

import math

import torch
from torch import nn


def _linear(in_f: int, out_f: int, w_bound: float | None, generator, device) -> nn.Linear:
    """``nn.Linear`` with W ~ U(+-w_bound) (``None``: lecun_normal) and the
    torch default bias."""
    layer = nn.Linear(in_f, out_f, device=device)
    with torch.no_grad():
        w = torch.empty(out_f, in_f)
        if w_bound is None:
            # flax lecun_normal: truncated normal, variance 1/in after truncation
            std = math.sqrt(1.0 / in_f) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        else:
            w.uniform_(-w_bound, w_bound, generator=generator)
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
        self.first_omega_0, self.hidden_omega_0 = float(first_omega_0), float(hidden_omega_0)
        self.omegas = (float(first_omega_0),) + (float(hidden_omega_0),) * hidden_layers
        self.acts = ("sine",) * (1 + hidden_layers) + ("none",)

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


class PerturbHead(nn.Module):
    """Linear, tanh, Linear, ``eps * tanh``: the perturbation branch of the
    ERD Siren (``w_bound`` ``None``: lecun_normal weights)."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 w_bound_of=None, generator: torch.Generator | None = None, device=None):
        super().__init__()
        bound = (lambda fan_in: None) if w_bound_of is None else w_bound_of
        self.fc0 = _linear(in_features, hidden, bound(in_features), generator, device)
        self.fc1 = _linear(hidden, out, bound(hidden), generator, device)

    def forward(self, x: torch.Tensor, eps: float | torch.Tensor) -> torch.Tensor:
        return eps * torch.tanh(self.fc1(torch.tanh(self.fc0(x))))


class SirenERD(nn.Module):
    """The INR_ERD.py Siren: first SineLayer, ``hidden_layers`` hidden
    SineLayers, Linear(hidden, hidden) + ReLU, Linear(hidden, out) + ReLU;
    with ``perturb``, a :class:`PerturbHead` on concat(coords, acq id) whose
    ``out_features``-wide output is broadcast-added to the coordinates.

    ``weights()`` is the trunk (what K1 takes, the perturbation branch
    stays outside the kernels), ``perturb_params()`` the branch."""

    def __init__(self, in_features: int = 2, hidden_features: int = 128,
                 hidden_layers: int = 3, out_features: int = 1,
                 first_omega_0: float = 30.0, hidden_omega_0: float = 30.0,
                 perturb: bool = False, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.config = dict(in_features=in_features, hidden_features=hidden_features,
                           hidden_layers=hidden_layers, out_features=out_features,
                           first_omega_0=first_omega_0, hidden_omega_0=hidden_omega_0,
                           perturb=perturb)
        H = hidden_features
        hidden_bound = lambda fan_in: math.sqrt(6.0 / fan_in) / hidden_omega_0
        # flax creates the perturbation branch first (it runs first)
        self.perturb = (PerturbHead(in_features + 1, H, out_features, hidden_bound,
                                    generator, device) if perturb else None)
        layers = [SineLayer(in_features, H, first_omega_0, True, generator, device)]
        layers += [SineLayer(H, H, hidden_omega_0, False, generator, device)
                   for _ in range(hidden_layers)]
        self.sines = nn.ModuleList(layers)
        self.head = _linear(H, H, None, generator, device)
        self.final = _linear(H, out_features, hidden_bound(H), generator, device)
        self.first_omega_0, self.hidden_omega_0 = float(first_omega_0), float(hidden_omega_0)
        self.acts = ("sine",) * (1 + hidden_layers) + ("relu", "relu")

    def weights(self) -> list[torch.Tensor]:
        out = []
        for layer in self.sines:
            out += [layer.linear.weight, layer.linear.bias]
        return out + [self.head.weight, self.head.bias, self.final.weight, self.final.bias]

    def perturb_params(self) -> list[torch.Tensor]:
        return [] if self.perturb is None else list(self.perturb.parameters())

    def trunk(self, coords: torch.Tensor) -> torch.Tensor:
        x = coords
        for layer in self.sines:
            x = layer(x)
        return torch.relu(self.final(torch.relu(self.head(x))))

    def forward(self, coords: torch.Tensor, sample: float | torch.Tensor = 0.0,
                eps: float = 0.0) -> torch.Tensor:
        """``coords`` (..., in); ``sample`` the acquisition id, a float or a
        tensor broadcastable to ``coords.shape[:-1] + (1,)``."""
        if self.perturb is not None:
            acq = torch.broadcast_to(torch.as_tensor(sample, dtype=coords.dtype,
                                                     device=coords.device),
                                     coords.shape[:-1] + (1,))
            coords = coords + self.perturb(torch.cat([coords, acq], dim=-1), eps)
        return self.trunk(coords)


class SirenToy(Siren):
    """The inr_toy.py Siren: the plain :class:`Siren` trunk and, with
    ``perturb``, a :class:`PerturbHead` ``(in + 1) -> (in + 1) -> in``
    (lecun_normal weights) on concat(coords, acq id) whose output is added
    to the coordinates."""

    def __init__(self, in_features: int = 2, hidden_features: int = 128,
                 hidden_layers: int = 3, out_features: int = 1,
                 first_omega_0: float = 30.0, hidden_omega_0: float = 30.0,
                 perturb: bool = False, generator: torch.Generator | None = None,
                 device=None):
        # flax creates the perturbation branch first (it runs first)
        head = (PerturbHead(in_features + 1, in_features + 1, in_features, None, generator,
                            device) if perturb else None)
        super().__init__(in_features, hidden_features, hidden_layers, out_features,
                         first_omega_0, hidden_omega_0, generator, device)
        self.perturb = head

    def forward(self, coords: torch.Tensor, sample: float | torch.Tensor = 0.0,
                eps: float = 0.0) -> torch.Tensor:
        if self.perturb is not None:
            acq = torch.broadcast_to(torch.as_tensor(sample, dtype=coords.dtype,
                                                     device=coords.device),
                                     coords.shape[:-1] + (1,))
            coords = coords + self.perturb(torch.cat([coords, acq], dim=-1), eps)
        return super().forward(coords)
