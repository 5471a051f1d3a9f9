"""PIA training: synthetic pretraining, PIDS-weighted fine-tuning, maps.

Counterpart of ``mri_super_resolution_tpu/pipelines/pia_train.py``
(``train_synthetic`` :32, ``finetune_on_voxels`` :88, ``predict_maps``
:122). The JAX loops are one scanned program each; here each is an eager
loop of autograd steps and the port's ``fit/optim.Adam`` (optax.adam's
numbers) over the module's parameters, updated in place. No loop reads a
value back: each step's loss goes into a tensor on the device.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from mri_super_resolution_tpu_torch.fit.optim import Adam
from mri_super_resolution_tpu_torch.models.pia import (
    PIA,
    pia_loss_supervised,
    pia_loss_unsupervised,
    synthetic_batch,
)


class PIATrainResult(NamedTuple):
    model: PIA  # trained in place
    losses: torch.Tensor  # per-step loss, on the model's device


def _fit(model: PIA, lr: float, steps: int, loss_fn) -> PIATrainResult:
    params = list(model.parameters())
    opt = Adam(params, lr)
    dev = params[0].device
    losses = torch.empty(steps, dtype=torch.float32, device=dev)
    for i in range(steps):
        with torch.enable_grad():
            loss = loss_fn(i)
            grads = torch.autograd.grad(loss, params)
        opt.step(grads)
        losses[i] = loss.detach()
    return PIATrainResult(model, losses)


def train_synthetic(model: PIA, generator: torch.Generator, steps: int = 2000,
                    batch_size: int = 256, lr: float = 1e-4, noise_std: float = 0.1,
                    supervised: bool = True,
                    noise_range: tuple[float, float] | None = None,
                    batches: Sequence[tuple] | None = None) -> PIATrainResult:
    """Pretrain on synthetic 3-compartment draws: the supervised composite
    loss, or (``supervised=False``) the MSE to the clean signal.

    ``noise_range=(lo, hi)`` draws a per-voxel sigma log-uniformly in [lo,
    hi] each step instead of the fixed ``noise_std``. ``batches`` gives
    each step's ``(signal, D, T2, v, clean)`` instead of drawing from
    ``generator`` (``steps`` of them)."""
    dev = next(model.parameters()).device

    def batch(i: int):
        if batches is not None:
            return [torch.as_tensor(t, device=dev) for t in batches[i]]
        sigma = noise_std
        if noise_range is not None:
            lo, hi = math.log(noise_range[0]), math.log(noise_range[1])
            u = torch.rand(batch_size, 1, generator=generator, device=generator.device)
            sigma = torch.exp(lo + (hi - lo) * u)
        return synthetic_batch(generator, batch_size, sigma, device=dev)

    def loss_fn(i: int):
        sig, D, T2, v, clean = batch(i)
        pred, _, pD, pT2, pv = model(sig)
        if supervised:
            return pia_loss_supervised(pred, pD, pT2, pv, clean, D, T2, v)
        return torch.mean((pred - clean) ** 2)

    return _fit(model, lr, steps if batches is None else len(batches), loss_fn)


def finetune_on_voxels(model: PIA, signals: torch.Tensor, pids: torch.Tensor,
                       steps: int = 500, lr: float = 1e-5) -> PIATrainResult:
    """Unsupervised PIDS-weighted fine-tune on real (N, 16) voxel signals
    (``pids`` (N, 16) or (N, 1) weights): PIA.loss_function's
    tissue_available=False branch."""
    return _fit(model, lr, steps,
                lambda i: pia_loss_unsupervised(model(signals)[0], signals, pids))


@torch.no_grad()
def predict_maps(model: PIA, signals: torch.Tensor, batch: int = 65536):
    """Per-voxel (D, T2, v), each (N, 3), encoded in chunks of ``batch``."""
    outs = [model.encode(signals[i:i + batch]) for i in range(0, signals.shape[0], batch)]
    return tuple(torch.cat(parts) for parts in zip(*outs))
