"""ERD (erroneous-repetition detection): outlier acquisition rejection.

Counterpart of ``mri_super_resolution_tpu/ops/erd.py``:

- :func:`auto_erd` (:113-170; master.py:76-93): a two-cluster agglomerative
  clustering of each pixel's acquisition intensities, complete linkage
  (master.py:78) or ward (superres.ipynb cell 10), then a rejection rule
  (mode 1 majority vote, mode 2 intensity-cognisant, mode 3 larger cluster).
  The JAX package ``vmap``s one pixel's ``scan`` of A - 2 merges; here the
  A - 2 merges are a Python loop of batched tensor ops over every pixel at
  once. Ties break as in the JAX package: a stable sort, and the first
  index of a minimum or maximum (``torch.argmin``/``argmax`` document it).
- :func:`soft_erd_mean` and :func:`soft_erd_weights` (:177-227;
  INR_ERD.py:126-160 and :222-236): softmax-temperature weighting with
  ``T = max(mul exp(-slope mean(x) / b0), 2)`` where the mean exceeds twice
  the noise level, including the JAX package's one-hot fallback where
  ``exp(x / T)`` would overflow float32.
"""
from __future__ import annotations

import torch


def _complete_linkage_split(values: torch.Tensor) -> torch.Tensor:
    """Two-cluster complete-linkage labels (0 lower, 1 upper) of each row of
    ``values`` (P, A). On 1-D data the clusters stay contiguous in sorted
    order, and merging the intervals across sorted gap k costs
    ``v[next active gap] - v[previous active gap + 1]``: A - 2 cheapest
    merges leave one gap, the split."""
    P, A = values.shape
    dev = values.device
    order = torch.argsort(values, dim=1, stable=True)
    v = torch.gather(values, 1, order)
    nb = A - 1
    idx = torch.arange(nb, device=dev)
    lt = idx[None, :] < idx[:, None]  # [k, j]: j < k
    gt = idx[None, :] > idx[:, None]
    active = torch.ones(P, nb, dtype=torch.bool, device=dev)
    rows = torch.arange(P, device=dev)
    for _ in range(A - 2):
        act = active[:, None, :]  # [p, k, j]: gap j active
        prev = torch.where(lt[None] & act, idx, -1).amax(dim=2)
        nxt = torch.where(gt[None] & act, idx, nb).amin(dim=2)
        cost = torch.gather(v, 1, nxt) - torch.gather(v, 1, prev + 1)
        cost = torch.where(active, cost, torch.full_like(cost, float("inf")))
        active[rows, torch.argmin(cost, dim=1)] = False
    split = torch.argmax(active.to(torch.int32), dim=1)
    labels_sorted = (torch.arange(A, device=dev)[None, :] > split[:, None]).to(torch.int32)
    return torch.zeros_like(labels_sorted).scatter_(1, order, labels_sorted)


def _segment_sums(labels: torch.Tensor, values: torch.Tensor):
    """(counts, sums) of each row's values per cluster id (0..A-1)."""
    counts = torch.zeros_like(values).scatter_add_(1, labels, torch.ones_like(values))
    sums = torch.zeros_like(values).scatter_add_(1, labels, values)
    return counts, sums


def _ward_split(values: torch.Tensor) -> torch.Tensor:
    """Two-cluster ward labels (0 lower-mean, 1 upper-mean) of each row of
    ``values`` (P, A): the full agglomeration, each of the A - 2 merges
    taking the pair of live clusters (i < j) of least
    ``n_i n_j / (n_i + n_j) (m_i - m_j)^2``; cluster j joins i."""
    P, A = values.shape
    dev = values.device
    ids = torch.arange(A, device=dev)
    upper_pair = ids[:, None] < ids[None, :]
    labels = ids.expand(P, A).clone()
    for _ in range(A - 2):
        counts, sums = _segment_sums(labels, values)
        means = sums / torch.clamp(counts, min=1.0)
        alive = counts > 0
        d = means[:, :, None] - means[:, None, :]
        cost = (counts[:, :, None] * counts[:, None, :]
                / torch.clamp(counts[:, :, None] + counts[:, None, :], min=1.0) * (d * d))
        valid = alive[:, :, None] & alive[:, None, :] & upper_pair[None]
        cost = torch.where(valid, cost, torch.full_like(cost, float("inf")))
        k = torch.argmin(cost.reshape(P, A * A), dim=1)
        i, j = k // A, k % A
        labels = torch.where(labels == j[:, None], i[:, None], labels)
    counts, sums = _segment_sums(labels, values)
    means = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                        torch.full_like(sums, float("-inf")))
    upper = torch.argmax(means, dim=1)
    return (labels == upper[:, None]).to(torch.int32)


def auto_erd(img: torch.Tensor, erd_map: torch.Tensor | None = None, mode: int = 1,
             linkage: str = "complete") -> torch.Tensor:
    """Per-pixel acceptance mask (H, W, A) of the (H, W, A) stack ``img``,
    int32, 1 = keep.

    mode 1: reject the minority cluster where the other holds >= 2/3 of A;
    mode 2: where ``erd_map > 0``, reject the lower-mean cluster;
    mode 3: keep only the strictly larger cluster, all on equal sizes.
    """
    A = img.shape[-1]
    flat = img.reshape(-1, A)
    if linkage == "complete":
        labels = _complete_linkage_split(flat)
    elif linkage == "ward":
        labels = _ward_split(flat)
    else:
        raise ValueError(f"linkage must be 'complete' or 'ward', got {linkage!r}")
    len1 = labels.sum(dim=1, keepdim=True)
    len0 = A - len1
    zero = torch.zeros_like(flat)
    sum1 = torch.where(labels == 1, flat, zero).sum(dim=1, keepdim=True)
    sum0 = torch.where(labels == 0, flat, zero).sum(dim=1, keepdim=True)
    mean1 = sum1 / torch.clamp(len1, min=1)
    mean0 = sum0 / torch.clamp(len0, min=1)
    if mode == 1:
        thresh = (2.0 / 3.0) * A
        reject = ((len0 >= thresh) & (labels == 1)) | ((len1 >= thresh) & (labels == 0))
        accept = ~reject
    elif mode == 2:
        if erd_map is None:
            raise ValueError("mode 2 requires erd_map")
        gate = erd_map.reshape(-1, 1) > 0
        reject = torch.where(mean1 > mean0, labels == 0, labels == 1)
        accept = ~(gate & reject)
    elif mode == 3:
        accept = (((len1 > len0) & (labels == 1)) | ((len0 > len1) & (labels == 0))
                  | (len0 == len1))
    else:
        raise ValueError(f"mode must be 1, 2 or 3, got {mode}")
    return accept.to(torch.int32).reshape(img.shape)


def _soft_temperature(x_mean, b0, mul: float, slope: float) -> torch.Tensor:
    return torch.clamp(mul * torch.exp(-slope * (x_mean / b0)), min=2.0)


def soft_erd_mean(acq: torch.Tensor, b0: torch.Tensor, noise_level,
                  mul: float = 1000.0, slope: float = 20.0) -> torch.Tensor:
    """Softmax-temperature weighted mean image of the (H, W, A) stack
    (``calc_adc_erd_single2``); the plain mean at or below twice the noise."""
    x_mean = acq.mean(dim=-1)
    temp = _soft_temperature(x_mean, b0, mul, slope)
    w = torch.softmax(acq / temp[..., None], dim=-1)
    soft = torch.sum(w * acq, dim=-1)
    return torch.where(x_mean > 2.0 * noise_level, soft, x_mean)


def soft_erd_weights(acq: torch.Tensor, b0: torch.Tensor, noise_level,
                     mul: float = 1000.0, slope: float = 20.0) -> torch.Tensor:
    """Per-acquisition loss weights: ``exp(x / T)`` (unnormalised, as the
    reference) above twice the noise, ``1 / A`` elsewhere; where ``x / T``
    exceeds 80 anywhere along a pixel, a one-hot on its first largest
    acquisition instead (the reference's intended fallback)."""
    A = acq.shape[-1]
    x_mean = acq.mean(dim=-1)
    temp = _soft_temperature(x_mean, b0, mul, slope)
    z = acq / temp[..., None]
    overflow = z.amax(dim=-1, keepdim=True) > 80.0
    onehot = torch.nn.functional.one_hot(torch.argmax(z, dim=-1), A).to(acq.dtype)
    w = torch.where(overflow, onehot, torch.exp(torch.clamp(z, max=80.0)))
    uniform = torch.full_like(acq, 1.0 / A)
    return torch.where((x_mean > 2.0 * noise_level)[..., None], w, uniform)
