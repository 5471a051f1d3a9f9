"""Plain reference of ``ens2d_siren_reference``: master.py's 2-D
directional ensemble (per direction a Siren 2 -> 64 x 7 -> 1 fitted with
the acceptance-weighted MSE, one Adam update per acquisition), in float32
PyTorch and NumPy.

Works out again from the raw ROI stack and the initial weights: AutoERD's
acceptance mask (complete-linkage two-cluster split of each pixel's
intensities, master.py:76-93, rule 1: reject the minority cluster where
the other holds at least two thirds), the Normalize(0.5, 0.5) targets, and
each direction's loss, gradients and Adam update of the first updates.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import plain


def complete_linkage_mode1(values: np.ndarray) -> np.ndarray:
    """Acceptance (P, A) int32 of the rows of ``values`` (P, A) float32.

    Complete linkage on a line merges neighbouring intervals of the sorted
    values, at the cost of the merged interval's span; the A - 2 cheapest
    merges (the first on a tie, the values sorted stably) leave two
    clusters. Rule 1 rejects the members of a cluster whose other holds at
    least 2A/3 of the values."""
    P, A = values.shape
    order = np.argsort(values, axis=1, kind="stable")
    v = np.take_along_axis(values, order, axis=1)
    lo = np.tile(np.arange(A), (P, 1))
    hi = lo.copy()
    rows = np.arange(P)
    for n in range(A, 2, -1):
        cost = (np.take_along_axis(v, hi[:, 1:], axis=1)
                - np.take_along_axis(v, lo[:, :-1], axis=1))
        i = np.argmin(cost, axis=1)
        hi[rows, i] = hi[rows, i + 1]
        keep = np.ones((P, n), dtype=bool)
        keep[rows, i + 1] = False
        lo, hi = lo[keep].reshape(P, n - 1), hi[keep].reshape(P, n - 1)
    upper_sorted = (np.arange(A)[None, :] > hi[:, :1]).astype(np.int32)
    labels = np.empty_like(upper_sorted)
    np.put_along_axis(labels, order, upper_sorted, axis=1)
    n1 = labels.sum(axis=1, keepdims=True)
    n0 = A - n1
    thresh = 2.0 * A / 3.0
    reject = ((n0 >= thresh) & (labels == 1)) | ((n1 >= thresh) & (labels == 0))
    return (~reject).astype(np.int32)


def prep(inputs: dict, cfg: dict) -> dict:
    """``coords`` (P, 2), ``pixels`` and ``weights`` (D, A, P, 1): each
    direction's acquisitions in Normalize(0.5, 0.5) space and their AutoERD
    acceptance."""
    roi = inputs["roi"]
    H, W, A = roi.shape
    flat = roi.reshape(-1, A)
    accept = complete_linkage_mode1(flat.cpu().numpy())
    acqs = cfg["acquisitions"]
    pixels, weights, at = [], [], 0
    for n in acqs:
        pixels.append(((flat[:, at:at + n] - 0.5) / 0.5).T[..., None])
        weights.append(torch.as_tensor(accept[:, at:at + n].T[..., None],
                                       dtype=torch.float32, device=roi.device))
        at += n
    return {"coords": plain.grid((H, W), roi.device), "pixels": torch.stack(pixels),
            "weights": torch.stack(weights), "accept": accept.reshape(H, W, A)}


def updates(inputs: dict, cfg: dict, prepped: dict, n: int) -> dict:
    """The first ``n`` updates (acquisition slots 0 .. n-1 of the first
    step) of each direction's own Adam: each update's losses (D,), the
    first gradient and the weights after the n-th update, stacked (D, ...)
    like the inputs."""
    omega = cfg["omega"]
    x, t, w = prepped["coords"], prepped["pixels"], prepped["weights"]
    D = t.shape[0]
    opts = [plain.Adam([p[d] for p in inputs["params0"]], cfg["learning_rate"])
            for d in range(D)]
    losses, first = [], None
    for a in range(n):
        row, grads_d = [], []
        for d, opt in enumerate(opts):
            loss, grads = plain.loss_and_grads(
                lambda p, d=d: (w[d, a] * (plain.siren(p, x, omega) - t[d, a]) ** 2).mean(),
                opt.params)
            row.append(float(loss))
            grads_d.append(grads)
            opt.step(grads)
        losses.append(row)
        if first is None:
            first = [torch.stack(g) for g in zip(*grads_d)]
    params = [torch.stack(p) for p in zip(*(opt.params for opt in opts))]
    return {"losses": losses, "grad": first, "params": params}
