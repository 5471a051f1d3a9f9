"""The numbers that decide ``correct``: each compares what the program
produced with what the plain reference works out from the same inputs.

- a loss: ``|program - reference| / |reference|``, the worst over steps;
- a gradient or a change of the weights: per leaf (one tensor of one
  model), the gap between the program's norm and the reference's, over the
  larger of the reference's norm of that leaf and its median leaf's norm;
  the worst leaf, or the median leaf where the worst is one small leaf's
  noise (the 2-D ensemble's change). Leaves whose reference gradient is under a thousandth of
  the median leaf's (nought to rounding: they move under Adam by round-off
  alone) are left out of both;
- an array (features, targets, outputs): the largest absolute difference
  over the reference's largest magnitude.
"""
from __future__ import annotations

import torch

QUIET = 1e-3  # a leaf whose reference gradient norm is under QUIET x the median's is left out


def _f64(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float64)


def loss_gap(program, reference) -> float:
    return max(abs(float(p) - float(r)) / max(abs(float(r)), 1e-30)
               for p, r in zip(program, reference, strict=True))


def leaves(tensors, stacked: bool) -> list[torch.Tensor]:
    """The leaves of a weight list: each tensor, or with ``stacked`` each
    model's slice of each (D, ...) tensor."""
    out = []
    for t in tensors:
        t = _f64(t)
        out += list(t) if stacked else [t]
    return out


def quiet_leaves(ref_grad: list[torch.Tensor]) -> set[int]:
    norms = torch.stack([g.norm() for g in ref_grad])
    cut = QUIET * float(norms.median())
    return {i for i, n in enumerate(norms.tolist()) if n < cut}


def leaf_gaps(program: list[torch.Tensor], reference: list[torch.Tensor],
              skip: set[int]) -> list[float]:
    """Each leaf's gap of norms (the leaves in ``skip`` left out)."""
    ref_norms = torch.stack([r.norm() for r in reference])
    median = float(ref_norms.median())
    return [abs(float(p.norm()) - float(ref_norms[i])) / max(float(ref_norms[i]), median, 1e-30)
            for i, (p, r) in enumerate(zip(program, reference, strict=True)) if i not in skip]


def norm_gap(program, reference, skip: set[int]) -> float:
    """The worst leaf's gap of norms."""
    return max(leaf_gaps(program, reference, skip))


def array_gap(program, reference) -> float:
    p, r = _f64(program), _f64(reference)
    if p.shape != r.shape:
        return float("inf")
    return float((p - r).abs().max()) / max(float(r.abs().max()), 1e-30)


def training(program: dict, reference: dict, start, stacked: bool) -> dict:
    """``loss_gap`` (every step followed), ``grad_gap``, and the change of
    the weights as ``change_gap`` (the worst leaf), ``change_median_gap``
    (the median leaf) and ``change_total_gap`` (all leaves as one vector)
    of the first steps:
    ``program`` and ``reference`` hold ``losses``, ``grad`` (the first
    gradient) and ``params`` (after the last step followed); ``start`` is
    the initial weights."""
    ref_grad = leaves(reference["grad"], stacked)
    skip = quiet_leaves(ref_grad)
    begin = leaves(start, stacked)
    change = lambda ps: [a - b for a, b in zip(leaves(ps, stacked), begin)]
    prog_change, ref_change = change(program["params"]), change(reference["params"])
    changes = leaf_gaps(prog_change, ref_change, skip)
    whole = lambda ls: float(torch.cat([t.reshape(-1) for i, t in enumerate(ls)
                                        if i not in skip]).norm())
    return {
        "loss_gap": loss_gap(_flat(program["losses"]), _flat(reference["losses"])),
        "grad_gap": norm_gap(leaves(program["grad"], stacked), ref_grad, skip),
        "change_gap": max(changes),
        "change_median_gap": float(torch.tensor(changes).median()),
        "change_total_gap": abs(whole(prog_change) - whole(ref_change)) / whole(ref_change),
    }


def _flat(values) -> list[float]:
    if not isinstance(values, (list, tuple)):
        return [float(values)]
    out = []
    for v in values:
        out += _flat(v) if isinstance(v, (list, tuple)) else [float(v)]
    return out
