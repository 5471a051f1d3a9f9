"""Cross-b combination expansion and the combination mean, on torch.

Counterpart of ``mri_super_resolution_tpu/data/combinations.py``
(``expand_combinations`` :23-53, ``combination_mean`` :56-71,
``expand_from_hybrid`` :74-86). The Cartesian
product of the acquisitions at each b-value is one broadcast; the order is
the reference's itertools.product order, k fastest.
"""
from __future__ import annotations

import numpy as np
import torch


def expand_combinations(b0: torch.Tensor, b1: torch.Tensor, b2: torch.Tensor,
                        b3: torch.Tensor) -> torch.Tensor:
    """(H, W, S) or (H, W, S, 1) b0 and (H, W, S, A_i) stacks at the three
    nonzero b-values -> (H, W, S, 4, A1*A2*A3), index a enumerating (i, j, k)
    with k fastest."""
    if b0.dim() == 3:
        b0 = b0[..., None]
    H, W, S = b0.shape[:3]
    A1, A2, A3 = b1.shape[-1], b2.shape[-1], b3.shape[-1]
    n = A1 * A2 * A3
    rows = [
        r.expand(H, W, S, A1, A2, A3).reshape(H, W, S, n)
        for r in (
            b0.reshape(H, W, S, 1, 1, 1),
            b1[..., :, None, None],
            b2[..., None, :, None],
            b3[..., None, None, :],
        )
    ]
    return torch.stack(rows, dim=3)


def combination_mean(hybrid_raw_norm, te: int = 1,
                     device: str | torch.device = "cpu") -> torch.Tensor:
    """Mean over all cross-b combinations without the product: each
    acquisition at a given b appears equally often, so the mean of each
    b-row is that b's plain acquisition mean. (X, Y, S, 4) float32.

    The acquisitions are summed one after another in float32 and divided by
    their count, which is the order numpy's ``mean`` takes over so short an
    axis, so the result equals the reference's bit for bit."""
    rows = []
    for b in range(4):
        a = torch.as_tensor(np.asarray(hybrid_raw_norm[b][te], dtype=np.float32),
                            device=device)
        if a.dim() == 4:
            total = a[..., 0].clone()
            for i in range(1, a.shape[-1]):
                total += a[..., i]
            a = total / a.shape[-1]
        rows.append(a)
    return torch.stack(rows, dim=3)


def expand_from_hybrid(hybrid_raw_norm, te: int = 1,
                       device: str | torch.device = "cpu") -> torch.Tensor:
    """:func:`expand_combinations` of the nested ``hybrid_raw[b][te]``
    layout at one TE index (the reference fixes TE=70ms, SRDWI.py:145)."""
    rows = [torch.as_tensor(np.asarray(hybrid_raw_norm[b][te]), device=device)
            for b in range(4)]
    return expand_combinations(*rows)
