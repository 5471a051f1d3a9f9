"""MISR Trainer: checkpointed RAMS training with the shift-tolerant loss.

Counterpart of ``mri_super_resolution_tpu/fit/trainer.py`` (reference:
multi-image-super-resolution/utils/training.py:29-220), with its semantics:
- one weighted step: the loss is ``sum(per * w) / sum(w)`` over per-image
  losses with ``w = 1``, the batch mean, and cPSNR is weighted alike;
- ``torch.optim.Adam`` at a constant learning rate, or cosine-decayed to 0
  over ``decay_steps`` applied updates (optax's ``cosine_decay_schedule``
  with ``alpha = 0``, which counts applied updates);
- a non-finite loss leaves the params, the Adam moments and the schedule's
  count unchanged, and the batch is not counted;
- with ``ema_decay`` an exponential moving average ``e = d e + (1 - d) p``
  after every step, skipped ones included; validation, best-checkpoint
  gating and serving use it;
- ``grad_accum`` micro-batches contribute weighted sums, divided once: one
  optimizer step on the concatenated batch;
- every epoch's batches include the ragged tail; ``evaluate`` weights each
  batch by its samples;
- scalar logs as CSV under ``log_dir``, plus TensorBoard event files when
  ``tensorboard`` is set;
- ``init`` restores the latest checkpoint; a checkpoint whose optimizer
  state does not fit restores the params and resets the moments.

What differs: the model is an ``nn.Module`` that arrives with its
parameters (drawn from a ``torch.Generator`` or loaded); the trainer runs it
on an explicit device (``cuda`` by default, raising without a card).
Shuffling and augmentation draw from a ``torch.Generator`` seeded from
``seed``, never compared with the JAX package's ``jax.random`` draws.
Checkpoints are the port's own files (``utils/checkpoint.py``).

``mesh`` (a ``parallel/mesh.py`` mesh; the JAX package's :80-87,
:223-291): batch data parallelism over the mesh's ``data`` ranks. Every rank
draws the same shuffled global batch from the same seeded generator, pads a
ragged one to a multiple of the data size with copies of its first sample
at w = 0 (``_pad_shard`` there), and takes its contiguous slice. Each rank
computes the sums of per-image loss and cPSNR times w, the sum of w and
the gradient of its weighted loss; one ``all_reduce`` sums them over the
data group and the step divides once, so the step equals one on the whole
batch. The non-finite check reads the reduced loss: every rank steps or
skips together. Only the mesh's first rank writes checkpoints and logs.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from mri_super_resolution_tpu_torch import resolve_device
from mri_super_resolution_tpu_torch.config import TrainerConfig
from mri_super_resolution_tpu_torch.ops.shift_metrics import shift_l1_loss, shift_psnr
from mri_super_resolution_tpu_torch.parallel.mesh import Mesh, all_reduce_sum, local_slice
from mri_super_resolution_tpu_torch.utils.checkpoint import CheckpointManager
from mri_super_resolution_tpu_torch.utils.tbevents import EventWriter

Batch = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]  # lr, hr, mask, w


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Adam
    step: int = 0
    # exponential moving average of the params (None unless ema_decay > 0),
    # keyed like model.state_dict(); params stay the optimizer's trajectory
    ema_params: dict[str, torch.Tensor] | None = None

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def _augment_batch(generator: torch.Generator, lr, hr, mask):
    """Random flip (of W) and rot90 in the (H, W) plane, applied alike to
    LR, HR and mask (training.py:14-27)."""
    flip = bool(torch.rand((), generator=generator) < 0.5)
    k = int(torch.randint(0, 4, (), generator=generator))
    return tuple(torch.rot90(x.flip(2) if flip else x, k, dims=(1, 2)) for x in (lr, hr, mask))


class Trainer:
    """Train a RAMS-style model with shift-tolerant L1 and cPSNR tracking."""

    def __init__(self, model: nn.Module, cfg: TrainerConfig,
                 loss_fn: Callable = shift_l1_loss, metric_fn: Callable = shift_psnr,
                 name: str = "RAMS", device: str | torch.device = "cuda",
                 mesh: Mesh | None = None):
        """``metric_fn`` must take ``reduce=False`` and return per-image
        values (``shift_psnr`` does). ``mesh``: batch data parallelism over
        its ``data`` axis (module docstring)."""
        if cfg.lr_schedule == "cosine":
            if cfg.decay_steps <= 0:
                raise ValueError("lr_schedule='cosine' needs decay_steps > 0")
        elif cfg.lr_schedule != "constant":
            raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
        if not 0.0 <= cfg.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1), got {cfg.ema_decay}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.metric_fn = metric_fn
        self.name = name
        self.mesh = mesh
        self._n_shard = 1 if mesh is None else mesh.axis_size("data")
        # the rank that writes checkpoints and logs
        self._lead = mesh is None or mesh.rank == mesh.ranks[0]
        self._ema = cfg.ema_decay > 0.0
        self._accum = max(1, int(cfg.grad_accum))
        self.manager = CheckpointManager(cfg.checkpoint_dir, cfg.max_to_keep)
        self.state: TrainState | None = None
        self.log_rows: list[tuple] = []
        self._last_val_loss = 0.0
        # train_<name> and test_<name> runs under log_dir, tags Loss / PSNR
        # (training.py:128-129); additive to the CSV
        self._tb_train: EventWriter | None = None
        self._tb_test: EventWriter | None = None
        if cfg.tensorboard and self._lead:
            self._tb_train = EventWriter(os.path.join(cfg.log_dir, f"train_{name}"))
            self._tb_test = EventWriter(os.path.join(cfg.log_dir, f"test_{name}"))

    def learning_rate(self, count: int) -> float:
        """The step size of the update after ``count`` applied updates."""
        lr = self.cfg.learning_rate
        if self.cfg.lr_schedule == "cosine":
            frac = min(count, self.cfg.decay_steps) / self.cfg.decay_steps
            lr *= 0.5 * (1.0 + math.cos(math.pi * frac))
        return lr

    def _adam(self) -> torch.optim.Adam:
        return torch.optim.Adam(self.model.parameters(), lr=self.cfg.learning_rate)

    # ------------------------------------------------------------------
    def init(self) -> TrainState:
        """The state at the model's current params, or at the latest
        checkpoint when there is one."""
        ema = ({k: p.detach().clone() for k, p in self.model.named_parameters()}
               if self._ema else None)
        state = TrainState(self.model, self._adam(), 0, ema)
        self.state = self.restore(state) or state
        return self.state

    def restore(self, template: TrainState) -> TrainState | None:
        latest = self.manager.latest_step()
        if latest is None:
            return None
        tree = self.manager.restore(latest)
        self.model.load_state_dict(tree["params"])
        optimizer = template.optimizer
        try:
            optimizer.load_state_dict(tree["opt_state"])
        except (KeyError, TypeError, ValueError):
            # another optimizer's layout: keep the trained params, restart
            # the moments (and the schedule's count with them)
            optimizer = self._adam()
            print("checkpoint layout differs from this config's optimizer; "
                  "params restored, optimizer moments reset")
        ema = None
        if self._ema:
            # resuming an EMA run restores its EMA; enabling EMA on a
            # checkpoint without one seeds it at the restored params
            src = tree.get("ema_params") or tree["params"]
            ema = {k: src[k].to(self.device, torch.float32).clone()
                   for k, _ in self.model.named_parameters()}
        print(f"Model restored from checkpoint at step {tree['step']}.")
        return TrainState(self.model, optimizer, int(tree["step"]), ema)

    def _save(self, psnr: float) -> bool:
        if not self._lead:
            return False
        tree = {"params": self.model.state_dict(),
                "opt_state": self.state.optimizer.state_dict(),
                "step": self.state.step, "psnr": float(psnr)}
        if self._ema:
            tree["ema_params"] = self.state.ema_params
        return self.manager.save(self.state.step, tree, metric=float(psnr),
                                 best_only=self.cfg.save_best_only)

    # ------------------------------------------------------------------
    def _batch(self, idx, x, hr, mask) -> Batch:
        """This rank's part of the batch ``idx``: padded to a multiple of the
        data size with copies of its first sample at w = 0, then sliced (one
        process: the whole batch, w = 1)."""
        arrays = (x[idx], hr[idx], mask[idx])
        w = np.ones(len(idx), np.float32)
        pad = (-len(idx)) % self._n_shard
        if pad:
            arrays = tuple(np.concatenate([a, np.repeat(a[:1], pad, axis=0)]) for a in arrays)
            w = np.concatenate([w, np.zeros(pad, np.float32)])
        if self.mesh is not None:
            sl = local_slice(len(w), self.mesh, "data")
            arrays, w = tuple(a[sl] for a in arrays), w[sl]
        dev = self.device
        return (*(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrays),
                torch.as_tensor(w, device=dev))

    def _reduce(self, tensors: list) -> list:
        """Sums over the mesh's data ranks (one process: as they are)."""
        return tensors if self.mesh is None else all_reduce_sum(tensors, self.mesh, "data")

    def _per_image(self, batch: Batch, params=None):
        """(per-image loss, sr) of one batch, through ``params`` if given."""
        lr, hr, mask, _ = batch
        sr = (self.model(lr) if params is None
              else torch.func.functional_call(self.model, params, (lr,)))
        return self.loss_fn(hr, sr, mask, self.cfg.hr_size), sr

    def train_step(self, micro_batches: Sequence[Batch]) -> tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step over one or more micro-batches: (loss, cPSNR),
        both weighted means over the samples. A non-finite loss applies no
        update; the EMA moves in either case."""
        state = self.state
        state.optimizer.zero_grad(set_to_none=True)
        wsum = self._reduce([sum(b[3].sum() for b in micro_batches)])[0]
        loss_sum = psnr_sum = 0.0
        for batch in micro_batches:
            per, sr = self._per_image(batch)
            w = batch[3]
            part = (per * w).sum()
            # one batch: the gradient of the weighted mean itself; several:
            # of each weighted sum, divided once below
            (part / wsum if len(micro_batches) == 1 else part).backward()
            with torch.no_grad():
                per_psnr = self.metric_fn(batch[1], sr.detach(), batch[2], self.cfg.hr_size,
                                          reduce=False)
            loss_sum = loss_sum + part.detach()
            psnr_sum = psnr_sum + (per_psnr * w).sum()
        params = [p for p in self.model.parameters() if p.grad is not None]
        if self.mesh is not None:
            loss_sum, psnr_sum, *grads = self._reduce([loss_sum, psnr_sum,
                                                       *(p.grad for p in params)])
            for p, g in zip(params, grads):
                p.grad.copy_(g)
        loss = loss_sum / wsum
        if bool(torch.isfinite(loss)):
            if len(micro_batches) > 1:
                for p in params:
                    p.grad.div_(wsum)
            first = state.optimizer.state.get(params[0], {}) if params else {}
            count = int(first.get("step", 0))
            for group in state.optimizer.param_groups:
                group["lr"] = self.learning_rate(count)
            state.optimizer.step()
        if self._ema:
            d = self.cfg.ema_decay
            with torch.no_grad():
                for k, p in self.model.named_parameters():
                    state.ema_params[k].mul_(d).add_(p, alpha=1.0 - d)
        return loss, psnr_sum / wsum

    def fit(self, x: np.ndarray, y: tuple[np.ndarray, np.ndarray],
            validation_data: tuple | None = None, epochs: int | None = None,
            seed: int = 0) -> TrainState:
        """``x`` (N, h, w, T) LR stacks, ``y`` = (HR, HR mask)."""
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        hr_imgs, hr_masks = y
        state = self.state or self.init()
        gen = torch.Generator().manual_seed(seed + 1)
        bs = cfg.batch_size
        for epoch in range(epochs):
            perm = torch.randperm(len(x), generator=gen).numpy()
            # shuffled batches including the ragged remainder (training.py:119)
            batches = [perm[i:i + bs] for i in range(0, len(x), bs)]
            train_loss, train_psnr = [], []
            for g0 in range(0, len(batches), self._accum):
                group = []
                for idx in batches[g0:g0 + self._accum]:
                    batch = self._batch(idx, x, hr_imgs, hr_masks)
                    if cfg.data_aug:
                        batch = (*_augment_batch(gen, *batch[:3]), batch[3])
                    group.append(batch)
                loss, psnr = self.train_step(group)
                loss_f = float(loss)
                if not np.isfinite(loss_f):
                    print(f"step {state.step}: non-finite loss, batch skipped")
                    continue
                state.step += 1
                train_loss.append(loss_f)
                train_psnr.append(float(psnr))
                if self._tb_train is not None:
                    # running-epoch means (tf.keras.metrics.Mean, training.py:157-162)
                    self._tb_train.add_scalar("Loss", float(np.mean(train_loss)), state.step)
                    self._tb_train.add_scalar("PSNR", float(np.mean(train_psnr)), state.step)
                if validation_data is not None and state.step % cfg.evaluate_every == 0:
                    val_psnr = self.evaluate(*validation_data)
                    self.log_rows.append(
                        (state.step, np.mean(train_loss), np.mean(train_psnr), val_psnr))
                    if self._tb_test is not None:
                        self._tb_test.add_scalar("Loss", self._last_val_loss, state.step)
                        self._tb_test.add_scalar("PSNR", val_psnr, state.step)
                        self._tb_train.flush()
                        self._tb_test.flush()
                    self._save(val_psnr)
            if self._lead:
                print(f"Epoch {epoch + 1}/{epochs}: loss {np.mean(train_loss):.2f} "
                      f"PSNR {np.mean(train_psnr):.2f}")
        if validation_data is None:
            self._save(float(np.mean(train_psnr)) if train_psnr else 0.0)
        self._flush_logs()
        return state

    def _flush_logs(self) -> None:
        """Append the scalar rows (training.py:128-129, 157-178) to
        ``<log_dir>/<name>_scalars.csv``."""
        if self._tb_train is not None:
            self._tb_train.flush()
            self._tb_test.flush()
        if not self.log_rows or not self._lead:
            self.log_rows.clear()
            return
        os.makedirs(self.cfg.log_dir, exist_ok=True)
        path = os.path.join(self.cfg.log_dir, f"{self.name}_scalars.csv")
        new = not os.path.exists(path)
        with open(path, "a") as f:
            if new:
                f.write("step,train_loss,train_psnr,val_psnr\n")
            for row in self.log_rows:
                f.write(",".join(str(v) for v in row) + "\n")
        self.log_rows.clear()

    @torch.no_grad()
    def evaluate(self, x_val, y_val, mask_val, params=None) -> float:
        """cPSNR over all samples, each batch (the ragged last one too)
        weighted by its samples; the EMA params when kept, unless
        ``params`` (a ``named_parameters`` dict) is given."""
        if params is None and self._ema:
            params = self.state.ema_params
        losses, psnrs, weights = [], [], []
        bs = self.cfg.batch_size
        for i in range(0, len(x_val), bs):
            idx = np.arange(i, min(i + bs, len(x_val)))
            batch = self._batch(idx, x_val, y_val, mask_val)
            per, sr = self._per_image(batch, params)
            w = batch[3]
            per_psnr = self.metric_fn(batch[1], sr, batch[2], self.cfg.hr_size, reduce=False)
            loss_sum, psnr_sum, wsum = self._reduce([(per * w).sum(), (per_psnr * w).sum(),
                                                     w.sum()])
            losses.append(float(loss_sum / wsum))
            psnrs.append(float(psnr_sum / wsum))
            weights.append(len(idx))
        if not losses:
            raise ValueError("evaluate() called with an empty validation set")
        self._last_val_loss = float(np.average(losses, weights=weights))
        return float(np.average(psnrs, weights=weights))
