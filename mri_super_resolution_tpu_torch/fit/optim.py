"""Adam with optional moment restarts, over a list of tensors, and its
stacked form over D independent slots.

Counterpart of ``mri_super_resolution_tpu/fit/optim.py``: ``Adam(lr)`` is
``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) in optax's
order of operations, and ``restart_adam(params, lr, every)`` (:33-78) resets
both moments *and* the bias-correction count before every ``every``-th
update (step > 0, step % every == 0). :class:`StackedAdam` is ``optax.adam``
under ``jax.vmap`` (the JAX package's 2-D ensemble and hybrid fits), with a
per-slot mask that leaves a slot's params, moments and count untouched.
Each ``step`` is an ``optim.step`` span (``utils/profiling.py``); ``count``
and ``step_index`` count the updates (by slot in :class:`StackedAdam`).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from mri_super_resolution_tpu_torch.utils.profiling import span


B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def _bias_correction(b: float, count: int) -> float:
    """``1 - b ** count`` in float32, as optax computes it."""
    return float(1 - np.float32(b) ** count)


def _adam_direction(m: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                   bc1, bc2) -> torch.Tensor:
    """optax.adam's arithmetic in its order: the moments ``m`` and ``v``
    updated in place from the gradient ``g`` (mu = (1 - b1) g + b1 mu;
    nu = (1 - b2) g^2 + b2 nu), and the step direction they give under the
    bias corrections ``bc1`` and ``bc2`` (Python floats, or columns a
    slot)."""
    m.mul_(B1).add_(g, alpha=1.0 - B1)
    v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
    return (m / bc1) / (torch.sqrt(v / bc2) + EPS)


class Adam:
    """Updates ``params`` in place from explicit gradients (no ``.grad``)."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 restart_every: int = 0):
        self.params = list(params)
        self.lr = float(lr)
        self.restart_every = int(restart_every)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0  # bias-correction count (optax ScaleByAdamState.count)
        self.step_index = 0  # restart schedule counter (never reset)

    @span("optim.step")
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
        bc1, bc2 = _bias_correction(B1, self.count), _bias_correction(B2, self.count)
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            p.sub_(self.lr * _adam_direction(m, v, g, bc1, bc2))


def restart_adam(params: Sequence[torch.Tensor], lr: float, every: int) -> Adam:
    """Adam whose moments and count reset every ``every`` steps
    (``every <= 0``: plain Adam)."""
    return Adam(params, lr, restart_every=max(int(every), 0))


def flat_view(tensors: Sequence[torch.Tensor]) -> torch.Tensor | None:
    """The (D, n) view of stacked tensors (each (D, ...)) that lie one after
    another in each row of one buffer, in order (the batched K1's grads, a
    :class:`StackedAdam`'s params); None when they do not."""
    first = tensors[0]
    D, row = first.shape[0], first.stride(0)
    at = first.storage_offset()
    for t in tensors:
        if (t.shape[0] != D or t.stride(0) != row or t.storage_offset() != at
                or t.untyped_storage().data_ptr() != first.untyped_storage().data_ptr()
                or not t[0].is_contiguous()):
            return None
        at += t[0].numel()
    n = at - first.storage_offset()
    return first.as_strided((D, n), (row, 1), first.storage_offset()) if n <= row else None


class StackedAdam:
    """Adam over D independent slots of stacked params (each (D, ...)):
    slot s is an :class:`Adam` of its own over ``[p[s] for p in params]``,
    with its own moments and bias-correction count. The D slots' params
    live in one (D, n_params) buffer whose views are :attr:`params`
    (initialised from ``params``), so that an update is a few elementwise
    launches over the buffer and not about eleven a tensor and slot.
    ``step(grads, ok)``: a slot whose ``ok`` is False keeps its params,
    moments and count (the JAX package's masked slots, which would
    otherwise advance the count and decay the moments); ``restart_every``
    is shared by the slots, each on its own count of real updates (as
    ``restart_adam``'s state under ``jax.vmap``, which a masked slot keeps).
    Elementwise the arithmetic is :class:`Adam`'s, in its order."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, restart_every: int = 0):
        params = list(params)
        D = int(params[0].shape[0])
        self.flat = torch.cat([p.detach().reshape(D, -1) for p in params], dim=1)
        n = self.flat.shape[1]
        self.params, at = [], 0
        for p in params:
            inner = p.shape[1:]
            strides = torch.empty(inner).stride() if len(inner) else ()
            self.params.append(self.flat.as_strided(p.shape, (n, *strides), at))
            at += inner.numel()
        self.lr = float(lr)
        self.restart_every = int(restart_every)
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = np.zeros(D, dtype=np.int64)  # per-slot bias-correction counts
        # per-slot restart schedule counters (never reset; a masked step
        # leaves its slot's, as the JAX package's masked slots keep theirs)
        self.step_index = np.zeros(D, dtype=np.int64)

    @span("optim.step")
    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor] | torch.Tensor,
             ok: Sequence[bool] | np.ndarray | None = None) -> None:
        """One update of the slots with ``ok`` True (default all) from
        stacked ``grads`` (a list like :attr:`params`, or their (D,
        n_params) flat form)."""
        D = self.flat.shape[0]
        ok = np.ones(D, dtype=bool) if ok is None else np.asarray(ok, dtype=bool)
        if not ok.any():
            return
        if self.restart_every > 0:
            restart = ok & (self.step_index > 0) & (self.step_index % self.restart_every == 0)
            if restart.all():
                self.mu.zero_()
                self.nu.zero_()
            elif restart.any():
                rows = self._to_device(torch.as_tensor(np.flatnonzero(restart)))
                self.mu[rows] = 0.0
                self.nu[rows] = 0.0
            self.count[restart] = 0
        self.step_index += ok
        g = grads if isinstance(grads, torch.Tensor) else flat_view(list(grads))
        if g is None:
            g = torch.cat([t.reshape(D, -1) for t in grads], dim=1)
        count = self.count + ok
        # bias corrections in float32 per slot, as Adam (and optax) computes
        # them: one pair of Python floats, as Adam divides by, when every
        # slot steps at one count (the fits' usual case), else a column a
        # slot (masked slots divide by 1; their results are not kept)
        bcs = [[_bias_correction(b, int(c)) if k else 1.0 for c, k in zip(count, ok)]
               for b in (B1, B2)]
        if ok.all() and (count == count[0]).all():
            bc1, bc2 = bcs[0][0], bcs[1][0]
        else:
            bc = self._to_device(torch.tensor(bcs, dtype=torch.float32))
            bc1, bc2 = bc[0][:, None], bc[1][:, None]
        if ok.all():  # in place, as Adam
            self.flat.sub_(self.lr * _adam_direction(self.mu, self.nu, g, bc1, bc2))
        else:
            m, v = self.mu.clone(), self.nu.clone()
            upd = _adam_direction(m, v, g, bc1, bc2)
            keep = self._to_device(torch.as_tensor(ok))[:, None]
            self.mu.copy_(torch.where(keep, m, self.mu))
            self.nu.copy_(torch.where(keep, v, self.nu))
            self.flat.copy_(torch.where(keep, self.flat - self.lr * upd, self.flat))
        self.count = count

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        """A small host tensor on the params' device without waiting for the
        device (through pinned memory on the card)."""
        if self.flat.device.type != "cuda":
            return t
        return t.pin_memory().to(self.flat.device, non_blocking=True)
