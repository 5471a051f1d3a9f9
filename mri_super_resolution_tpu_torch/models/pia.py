"""PIA: physics-informed autoencoder for the 3-compartment tissue fit.

Counterpart of ``mri_super_resolution_tpu/models/pia.py``: an MLP encoder
(16 -> 32-64-128-256-512, LeakyReLU 0.01) with three heads giving each
compartment's D, T2 and volume fraction v (epithelium, stroma, lumen),
bounded around the priors by ``mean + delta tanh`` (v by a softmax), and the
analytic decoder :func:`signal_model` over the 4 x 4 (b, TE) grid
(``signal_model`` :35, ``PIA`` :61 with ``encode`` :81 and ``decode`` :95,
the losses :103 and :108, ``synthetic_batch`` :121).

The JAX package's documented deviation from the reference is kept: the
encoder input is scaled by ``input_scale`` = 1e-3 (the signal model's S0 of
1000), so that activations start O(1); without it the heads saturate at
step 0 and training collapses to one prediction (``models/pia.py:63-72``
of the JAX package). Only the encoder input is scaled: the decoder and the
losses work on the raw signal.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mri_super_resolution_tpu_torch.models.grid_inr import lecun_dense

D_MEAN = (0.5, 1.2, 2.85)
T2_MEAN = (45.0, 70.0, 750.0)
D_DELTA = (0.2, 0.5, 0.15)
T2_DELTA = (25.0, 30.0, 250.0)
B_VALUES = (0.0, 150.0, 1000.0, 1500.0)
TE_VALUES = (0.0, 13.0, 93.0, 143.0)


def signal_model(D: torch.Tensor, T2: torch.Tensor, v: torch.Tensor,
                 b_values=B_VALUES, te_values=TE_VALUES) -> torch.Tensor:
    """``1000 sum_c v_c exp(-b/1000 D_c) exp(-TE/T2_c)`` for D, T2, v of
    shape (..., 3); returns (..., len(b) len(TE)), b outer, TE inner."""
    b = torch.as_tensor(b_values, dtype=D.dtype, device=D.device)[:, None]
    te = torch.as_tensor(te_values, dtype=D.dtype, device=D.device)[None, :]
    decay = (v[..., :, None, None]
             * torch.exp(-b / 1000.0 * D[..., :, None, None])
             * torch.exp(-te / T2[..., :, None, None]))
    sig = decay.sum(dim=-3)
    return 1000.0 * sig.reshape(sig.shape[:-2] + (-1,))


class PIA(nn.Module):
    """Encoder ``enc``, heads ``heads[D|T2|v]`` (``predictor_depth`` hidden
    Dense layers of the last encoder width, then 3 outputs), every Dense
    flax's default init (lecun_normal, zero bias)."""

    def __init__(self, number_of_signals: int = 16,
                 hidden_dims: Sequence[int] = (32, 64, 128, 256, 512),
                 predictor_depth: int = 1, D_mean=D_MEAN, T2_mean=T2_MEAN,
                 D_delta=D_DELTA, T2_delta=T2_DELTA, b_values=B_VALUES,
                 TE_values=TE_VALUES, input_scale: float = 1e-3,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        dims = [number_of_signals, *hidden_dims]
        self.enc = nn.ModuleList([lecun_dense(dims[i], dims[i + 1], generator, device)
                                  for i in range(len(hidden_dims))])
        w = hidden_dims[-1]
        self.heads = nn.ModuleDict({
            name: nn.ModuleList([lecun_dense(w, w, generator, device)
                                 for _ in range(predictor_depth)]
                                + [lecun_dense(w, 3, generator, device)])
            for name in ("D", "T2", "v")})
        for name, val in (("D_mean", D_mean), ("T2_mean", T2_mean),
                          ("D_delta", D_delta), ("T2_delta", T2_delta)):
            self.register_buffer(name, torch.tensor(val, dtype=torch.float32,
                                                    device=device), persistent=False)
        self.b_values, self.TE_values = tuple(b_values), tuple(TE_values)
        self.input_scale = float(input_scale)

    def _head(self, h: torch.Tensor, name: str) -> torch.Tensor:
        *hidden, out = self.heads[name]
        for lin in hidden:
            h = F.leaky_relu(lin(h), 0.01)
        return out(h)

    def encode(self, x: torch.Tensor):
        """(D, T2, v), each (..., 3)."""
        h = x * self.input_scale
        for lin in self.enc:
            h = F.leaky_relu(lin(h), 0.01)
        D = self.D_mean + self.D_delta * torch.tanh(self._head(h, "D"))
        T2 = self.T2_mean + self.T2_delta * torch.tanh(self._head(h, "T2"))
        v = torch.softmax(self._head(h, "v"), dim=-1)
        return D, T2, v

    def decode(self, D, T2, v) -> torch.Tensor:
        return signal_model(D, T2, v, self.b_values, self.TE_values)

    def forward(self, x: torch.Tensor):
        D, T2, v = self.encode(x)
        return self.decode(D, T2, v), x, D, T2, v


def pia_loss_unsupervised(pred_signal, true_signal, pids) -> torch.Tensor:
    """PIDS-weighted MSE (PIA.py:150-153)."""
    return torch.mean(pids * (pred_signal - true_signal) ** 2)


def pia_loss_supervised(pred_signal, pred_D, pred_T2, pred_v, true_signal, true_D,
                        true_T2, true_v) -> torch.Tensor:
    """MSE on signal, D and T2 plus torch's ``F.kl_div(pred_v, true_v)`` on
    the volume fractions, with the reference's weights (PIA.py:139-147)."""
    loss_signal = torch.mean((pred_signal - true_signal) ** 2)
    loss_D = torch.mean((pred_D - true_D) ** 2)
    loss_T2 = torch.mean((pred_T2 - true_T2) ** 2)
    loss_v = torch.mean(true_v * (torch.log(true_v + 1e-12) - pred_v))
    return loss_signal + loss_D + 1e-4 * loss_T2 + 0.2 * loss_v


def synthetic_batch(generator: torch.Generator, batch_size: int = 16, noise_std=0.1,
                    device=None):
    """A synthetic batch (PIA.py:171-213): D, T2 and v drawn uniformly within
    the physiological ranges, v normalised to sum 1, and Gaussian noise of
    ``1000 noise_std`` on the signal. ``noise_std`` is a scalar or a tensor
    broadcastable against (batch_size, 16), such as per-voxel sigmas of
    shape (batch_size, 1). Drawn on ``generator``'s device, returned on
    ``device`` (default: the same). Returns (signal, D, T2, v, clean)."""
    gdev = generator.device
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(batch_size, generator=generator,
                                                   device=gdev)
    D = torch.stack([u(0.3, 0.7), u(0.7, 1.7), u(2.7, 3.0)], -1)
    T2 = torch.stack([u(20.0, 70.0), u(40.0, 100.0), u(500.0, 1000.0)], -1)
    v = torch.stack([u(0.0, 1.0), u(0.0, 1.0), u(0.0, 1.0)], -1)
    v = v / v.sum(-1, keepdim=True)
    clean = signal_model(D, T2, v)
    sig = clean + 1000.0 * noise_std * torch.randn(clean.shape, generator=generator,
                                                   device=gdev)
    return tuple(t if device is None else t.to(device) for t in (sig, D, T2, v, clean))
