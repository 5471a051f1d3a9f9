"""Adam with optional moment restarts, over a list of tensors.

Counterpart of ``mri_super_resolution_tpu/fit/optim.py``: ``Adam(lr)`` is
``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) in optax's
order of operations, and ``restart_adam(params, lr, every)`` (:33-78) resets
both moments *and* the bias-correction count before every ``every``-th
update (step > 0, step % every == 0).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class Adam:
    """Updates ``params`` in place from explicit gradients (no ``.grad``)."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax.adam's defaults

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 restart_every: int = 0):
        self.params = list(params)
        self.lr = float(lr)
        self.restart_every = int(restart_every)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0  # bias-correction count (optax ScaleByAdamState.count)
        self.step_index = 0  # restart schedule counter (never reset)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        if (self.restart_every > 0 and self.step_index > 0
                and self.step_index % self.restart_every == 0):
            for m, v in zip(self.mu, self.nu):
                m.zero_()
                v.zero_()
            self.count = 0
        self.step_index += 1
        self.count += 1
        # bias corrections in float32, as optax computes them
        bc1 = float(1 - np.float32(self.b1) ** self.count)
        bc2 = float(1 - np.float32(self.b2) ** self.count)
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p.sub_(self.lr * upd)


def restart_adam(params: Sequence[torch.Tensor], lr: float, every: int) -> Adam:
    """Adam whose moments and count reset every ``every`` steps
    (``every <= 0``: plain Adam)."""
    return Adam(params, lr, restart_every=max(int(every), 0))
