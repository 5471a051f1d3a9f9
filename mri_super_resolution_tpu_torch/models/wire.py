"""WIRE: complex Gabor-wavelet INR on paired real tensors.

Counterpart of ``mri_super_resolution_tpu/models/wire.py`` (``ComplexDense``,
``ComplexGaborLayer``, ``Wire``): complex values travel as (real, imag)
pairs and every complex product is written out in real arithmetic,

    s  = W h + b,  s2 = W2 h + b2            (complex linears)
    h' = exp(i omega s) exp(-sigma^2 (|s|^2 + |s2|^2))
       = exp(-omega Im s) exp(-sigma^2 (...)) (cos(omega Re s) + i sin(...)),

with a real-input first layer (Im s = Im s2 = 0) and a final complex linear
whose real part is the output. Inits as the JAX package's: first-layer
weights U(+-1/in) (``siren_first_init``), complex weights lecun-normal, every
bias torch ``nn.Linear``'s U(+-1/sqrt(in)).

omega_0 and sigma_0 are per-layer parameters of shape (1,). They are always
read from the parameters; ``trainable`` only decides whether gradients flow
into them (the JAX model's ``stop_gradient``), so a checkpoint with trained
values computes with those values either way.

Parameter order of :meth:`Wire.params` (what the fit engine and the kernels
``ops/wire_kernel.py`` take): :meth:`Wire.weights` in the kernels' flat order
(``[W, b, Wo, bo]``, per hidden layer ``[Kr, Ki, br, bi, K2r, K2i, b2r,
b2i]``, then ``[Kr, Ki, br]`` of the final layer; torch (out, in) layout),
then :meth:`Wire.scales` ``[omega_0, sigma_0]`` per layer. The final layer's
``bias_i`` never reaches the output and is in neither list.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from mri_super_resolution_tpu_torch.models.perturbnet import _TRUNC_STD
from mri_super_resolution_tpu_torch.models.siren import _linear

FIRST_N, HIDDEN_N, FINAL_N = 4, 8, 3  # weights per layer in the flat order


def n_weights(n_hidden: int) -> int:
    """Length of :meth:`Wire.weights` for ``n_hidden`` hidden layers."""
    return FIRST_N + HIDDEN_N * n_hidden + FINAL_N


def _lecun(out_f: int, in_f: int, generator) -> torch.Tensor:
    std = math.sqrt(1.0 / in_f) / _TRUNC_STD
    w = torch.empty(out_f, in_f)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return w


class ComplexDense(nn.Module):
    """Parameters of the complex linear (Kr + i Ki)(zr + i zi) + (br + i bi)
    on (real, imag) pairs; :func:`wire_apply` applies them."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.weight_r = nn.Parameter(_lecun(out_features, in_features, generator))
        self.weight_i = nn.Parameter(_lecun(out_features, in_features, generator))
        self.bias_r = nn.Parameter(
            torch.empty(out_features).uniform_(-bound, bound, generator=generator))
        self.bias_i = nn.Parameter(
            torch.empty(out_features).uniform_(-bound, bound, generator=generator))
        self.to(device)


def _complex_linear(zr, zi, kr, ki, br, bi):
    out_r = zr @ kr.T - zi @ ki.T + br
    out_i = zr @ ki.T + zi @ kr.T + bi
    return out_r, out_i


class ComplexGaborLayer(nn.Module):
    """Parameters of a Gabor wavelet layer (the first one takes a real
    input); :func:`wire_apply` applies them."""

    def __init__(self, in_features: int, out_features: int, omega_0: float = 10.0,
                 sigma_0: float = 10.0, is_first: bool = False,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.is_first = is_first
        self.omega_0 = nn.Parameter(torch.full((1,), float(omega_0), device=device))
        self.sigma_0 = nn.Parameter(torch.full((1,), float(sigma_0), device=device))
        if is_first:
            self.linear = _linear(in_features, out_features, 1.0 / in_features,
                                  generator, device)
            self.scale_orth = _linear(in_features, out_features, 1.0 / in_features,
                                      generator, device)
        else:
            self.linear = ComplexDense(in_features, out_features, generator, device)
            self.scale_orth = ComplexDense(in_features, out_features, generator, device)

    def weights(self) -> list[torch.Tensor]:
        if self.is_first:
            return [self.linear.weight, self.linear.bias, self.scale_orth.weight,
                    self.scale_orth.bias]
        return [w for c in (self.linear, self.scale_orth)
                for w in (c.weight_r, c.weight_i, c.bias_r, c.bias_i)]


def _gabor(sr, si, s2r, s2i, omega, sigma):
    """The model's two-exponential form (``models/wire.py:91-93`` of the JAX
    package); ``si``/``s2i`` None for the real-input first layer."""
    if si is None:
        abs2, abs2_orth = sr * sr, s2r * s2r
        si = torch.zeros_like(sr)
    else:
        abs2, abs2_orth = sr * sr + si * si, s2r * s2r + s2i * s2i
    gauss = torch.exp(-(sigma * sigma) * (abs2 + abs2_orth))
    mag = torch.exp(-omega * si) * gauss
    return mag * torch.cos(omega * sr), mag * torch.sin(omega * sr)


def wire_apply(params: Sequence[torch.Tensor], x: torch.Tensor, n_hidden: int,
               trainable: bool = False) -> torch.Tensor:
    """Functional :class:`Wire` over ``params`` (:meth:`Wire.params` order);
    differentiable in ``x`` and the weights, and in omega/sigma only when
    ``trainable``."""
    nw = n_weights(n_hidden)
    w, scales = params[:nw], params[nw:]
    if len(scales) != 2 * (n_hidden + 1):
        raise ValueError(f"{len(params)} params do not fit {n_hidden} hidden layers")
    if not trainable:
        scales = [s.detach() for s in scales]
    sr = x @ w[0].T + w[1]
    s2r = x @ w[2].T + w[3]
    hr, hi = _gabor(sr, None, s2r, None, scales[0], scales[1])
    for l in range(n_hidden):
        k = w[FIRST_N + HIDDEN_N * l:FIRST_N + HIDDEN_N * (l + 1)]
        sr, si = _complex_linear(hr, hi, k[0], k[1], k[2], k[3])
        s2r, s2i = _complex_linear(hr, hi, k[4], k[5], k[6], k[7])
        hr, hi = _gabor(sr, si, s2r, s2i, scales[2 * l + 2], scales[2 * l + 3])
    f = w[nw - FINAL_N:]
    return hr @ f[0].T - hi @ f[1].T + f[2]


class Wire(nn.Module):
    """WIRE INR: a real-input Gabor layer, ``hidden_layers`` complex Gabor
    layers and a final complex linear whose real part is the one output (the
    pipeline's only use: the JAX model's ``out_features`` default)."""

    def __init__(self, in_features: int, hidden_features: int = 256,
                 hidden_layers: int = 2, omega_0: float = 10.0,
                 sigma_0: float = 10.0, trainable: bool = False,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.hidden_layers = int(hidden_layers)
        self.trainable = bool(trainable)
        layers = [ComplexGaborLayer(in_features, hidden_features, omega_0, sigma_0,
                                    True, generator, device)]
        layers += [ComplexGaborLayer(hidden_features, hidden_features, omega_0, sigma_0,
                                     False, generator, device)
                   for _ in range(hidden_layers)]
        self.layers = nn.ModuleList(layers)
        self.final = ComplexDense(hidden_features, 1, generator, device)

    def weights(self) -> list[torch.Tensor]:
        """The kernels' flat weight list (see the module docstring)."""
        out = [w for layer in self.layers for w in layer.weights()]
        return out + [self.final.weight_r, self.final.weight_i, self.final.bias_r]

    def scales(self) -> list[torch.Tensor]:
        """``[omega_0, sigma_0]`` of every layer, each of shape (1,)."""
        return [s for layer in self.layers for s in (layer.omega_0, layer.sigma_0)]

    def params(self) -> list[torch.Tensor]:
        return self.weights() + self.scales()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return wire_apply(self.params(), x, self.hidden_layers, self.trainable)
