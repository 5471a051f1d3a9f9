"""Test-time augmentation ensembles for MISR prediction.

Counterpart of ``mri_super_resolution_tpu/ops/tta.py`` (reference:
multi-image-super-resolution/utils/prediction.py:10-97): the clip/round
``predict_tensor`` wrapper, the RAMS+ geometric self-ensemble (8 flip/rot
combinations, predict, invert, average) and the temporal-permutation
ensemble. Shuffles draw from an explicit ``torch.Generator``; they cannot
reproduce ``jax.random``'s permutations.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def predict_tensor(apply_fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """Forward + clip to [0, 2^16] + round (prediction.py:76-83)."""
    sr = apply_fn(x.float())
    return torch.round(torch.clamp(sr, 0.0, 2.0 ** 16))


def _flip(x: torch.Tensor, do: bool) -> torch.Tensor:
    return x.flip(2) if do else x


def _rot(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.rot90(x, k, dims=(1, 2)) if k else x


def _permute_t(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    perm = torch.randperm(x.shape[-1], generator=generator).to(x.device)
    return x[..., perm]


def geometric_ensemble_predict(apply_fn: Callable, x: torch.Tensor,
                               generator: torch.Generator | None = None,
                               max_device_batch: int = 64) -> np.ndarray:
    """RAMS+ 8-fold flip/rotate self-ensemble (prediction.py:31-52) of
    ``x`` (B, H, W, T): each (flip, rot) variant is predicted, rotated back
    by 4 - k and flipped back, and the 8 are averaged. With ``generator``
    the temporal axis of each variant is shuffled. Square inputs ride one
    forward of batch 8 B while that is at most ``max_device_batch``; other
    inputs go variant by variant."""
    variants, metas = [], []
    for f in (0, 1):
        for k in range(4):
            xa = _rot(_flip(x, bool(f)), k)
            if generator is not None:
                xa = _permute_t(xa, generator)
            variants.append(xa)
            metas.append((bool(f), k))
    if x.shape[1] == x.shape[2] and 8 * x.shape[0] <= max_device_batch:
        srs = predict_tensor(apply_fn, torch.cat(variants, 0))
        B = x.shape[0]
        outs = [_flip(_rot(srs[i * B:(i + 1) * B], (4 - k) % 4), f)
                for i, (f, k) in enumerate(metas)]
    else:
        outs = [_flip(_rot(predict_tensor(apply_fn, xa), (4 - k) % 4), f)
                for xa, (f, k) in zip(variants, metas)]
    return np.mean([o.cpu().numpy() for o in outs], axis=0)


def temporal_permute_predict(apply_fn: Callable, x: torch.Tensor,
                             generator: torch.Generator, n_ens: int = 10) -> np.ndarray:
    """Temporal-permutation ensemble (prediction.py:86-97): the mean of the
    predictions over ``n_ens`` shuffles of the acquisition axis."""
    outs = [predict_tensor(apply_fn, _permute_t(x, generator)).cpu().numpy()
            for _ in range(n_ens)]
    return np.mean(outs, axis=0)
