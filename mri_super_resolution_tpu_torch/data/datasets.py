"""Coordinate/intensity datasets for INR fitting.

Counterpart of ``mri_super_resolution_tpu/data/datasets.py`` (``ImageFittingSet``
:30-80, ``flatten_weights`` :83-87; the reference's ``ImageFitting_set``,
SRDWI.py:20-39 and nn_mri.py:182-203): equally shaped images stacked once and
flattened to ``(N, P, 1)`` pixels on one shared ``(P, d)`` grid in [-1, 1]^d,
optionally through ``Normalize(0.5, 0.5)``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from mri_super_resolution_tpu_torch.core.coords import mgrid
from mri_super_resolution_tpu_torch.core.normalize import to_tensor_normalize


@dataclasses.dataclass
class ImageFittingSet:
    """pixels (N, P, 1); coords (P, d); shape: each image's shape; orig: the
    raw (N, *shape) stack in the normalised mode; mean: the raw images' mean
    over N."""

    pixels: torch.Tensor
    coords: torch.Tensor
    shape: tuple[int, ...]
    orig: torch.Tensor | None = None
    mean: torch.Tensor | None = None

    def __len__(self) -> int:
        return int(self.pixels.shape[0])

    @classmethod
    def from_images(cls, images: Sequence[np.ndarray] | np.ndarray,
                    normalize: bool = False) -> "ImageFittingSet":
        """Stack equally shaped images; ``normalize`` applies the 2-D
        pathway's ``Normalize(0.5, 0.5)`` to the pixels."""
        raw = torch.as_tensor(np.stack([np.asarray(im, dtype=np.float32) for im in images]))
        shape = tuple(int(s) for s in raw.shape[1:])
        stack = to_tensor_normalize(raw) if normalize else raw
        return cls(pixels=stack.reshape(raw.shape[0], -1, 1), coords=mgrid(shape),
                   shape=shape, orig=raw if normalize else None, mean=raw.mean(dim=0))

    def coords_for_all(self) -> torch.Tensor:
        """(N, P, d) broadcast view for APIs that want per-image coords."""
        return self.coords.expand(len(self), *self.coords.shape)


def flatten_weights(weights: Sequence[np.ndarray]) -> torch.Tensor:
    """Acceptance-weight stack -> (N, P, 1), the ``_accept_weights`` tensor of
    master.py:120-125."""
    w = torch.as_tensor(np.stack([np.asarray(x, dtype=np.float32) for x in weights]))
    return w.reshape(w.shape[0], -1, 1)
