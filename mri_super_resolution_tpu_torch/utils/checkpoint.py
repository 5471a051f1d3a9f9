"""Checkpoints of the MISR trainer: keep the N latest, track the best metric.

Counterpart of ``mri_super_resolution_tpu/utils/checkpoint.py``
(``CheckpointManager``, ``unwrap_trainer_params``), with the same
behaviour: the N latest steps are kept, ``best_metric.txt`` holds the best
metric seen, ``save(best_only=True)`` skips a step whose metric does not
improve on it (and raises without a metric), ``latest_step`` and
``restore(step=None)``.

The on-disk format is the port's own, not orbax's (orbax is a JAX library):
one ``<step>.pt`` file per step under the checkpoint directory, written with
``torch.save`` and read back onto the CPU with ``torch.load(...,
weights_only=True)``. The JAX package's orbax checkpoints do not load here,
nor these there; ``convert.py`` carries RAMS params across as ``.npz``.
"""
from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def unwrap_trainer_params(tree: Any) -> Any:
    """The serving params whether ``tree`` is bare params or a full Trainer
    checkpoint ``{step, psnr, params, opt_state[, ema_params]}``
    (``fit/trainer.py``). An EMA run's serving weights are the averaged ones
    (validation and best-checkpoint gating used them), so ``ema_params`` wins
    when present."""
    if isinstance(tree, dict) and "params" in tree and "step" in tree:
        ema = tree.get("ema_params")
        return ema if ema is not None else tree["params"]
    return tree


class CheckpointManager:
    """Step-indexed manager with best-metric gating (the TF
    CheckpointManager + save-best-only analog, training.py:88-102,
    183-187)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_metric = -np.inf
        if os.path.exists(self._best_path()):
            with open(self._best_path()) as f:
                self.best_metric = float(f.read().strip())

    def _best_path(self) -> str:
        return os.path.join(self.directory, "best_metric.txt")

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def save(self, step: int, tree: Any, metric: float | None = None,
             best_only: bool = False) -> bool:
        """Save ``tree`` at ``step``. With ``best_only`` the save is skipped
        unless ``metric`` improves on the stored best."""
        if best_only and metric is None:
            raise ValueError(
                "best_only=True requires a metric: saving unconditionally "
                "would rotate out the best checkpoints under max_to_keep")
        if best_only and metric <= self.best_metric:
            return False
        if metric is not None and metric > self.best_metric:
            self.best_metric = float(metric)
            with open(self._best_path(), "w") as f:
                f.write(str(self.best_metric))
        tmp = self._path(step) + f".{os.getpid()}.tmp"
        torch.save(tree, tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return True

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None) -> Any | None:
        """The tree saved at ``step`` (the latest when None), tensors on the
        CPU; None when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu", weights_only=True)
