"""Plain reference of ``sr3d_siren_reference``: superresDWI.py's volume fit
(FF-SIREN 256 -> 512 x 4 -> 1, Adam; PerturbNet 257 -> 128 -> 4) and its
dense-grid resampling, in float32 PyTorch.

Works everything out again from the raw inputs the benchmark made (the
patient's acquisition stacks, the Fourier matrix B and the initial
weights): the per-(b, TE) max normalisation, the combination mean on the LR
ROI, the cross-b combinations in ``itertools.product`` order, the Fourier
features, each step's loss, gradients and Adam update, and the dense grid's
coordinates and outputs.
"""
from __future__ import annotations

import itertools

import torch

from portbench import plain


def prep(inputs: dict, cfg: dict) -> dict:
    """``ff`` (P, 2m) Fourier features of the LR grid, ``mean_target`` (P,
    1), ``acq_pixels`` (N, P, 1): superresDWI.py:50-82."""
    vols = [v / v.max() for v in inputs["patient"]]
    r0, r1 = cfg["roi_start"], cfg["roi_end"]
    lr = [v[r0:r1:2, r0:r1:2] for v in vols]
    mean = torch.stack([v if v.dim() == 3 else v.mean(dim=-1) for v in lr], dim=3)
    coords = plain.grid(mean.shape, mean.device)
    stacks = [v[..., None] if v.dim() == 3 else v for v in lr]
    combos = [torch.stack([stacks[0][..., 0], stacks[1][..., i], stacks[2][..., j],
                           stacks[3][..., k]], dim=3).reshape(-1, 1)
              for i, j, k in itertools.product(*(range(s.shape[-1]) for s in stacks[1:]))]
    return {"ff": plain.fourier(coords, inputs["B"]), "mean_target": mean.reshape(-1, 1),
            "acq_pixels": torch.stack(combos)}


def mean_steps(inputs: dict, cfg: dict, prepped: dict, n: int) -> dict:
    """The first ``n`` INR-on-mean steps from the initial weights: each
    step's loss, the first gradient and the weights after the n-th step."""
    omega = cfg["omega"]
    ff, target = prepped["ff"], prepped["mean_target"]
    opt = plain.Adam(inputs["inr0"], cfg["inr_lr"])
    losses, first = [], None
    for _ in range(n):
        loss, grads = plain.loss_and_grads(
            lambda p: ((plain.siren(p, ff, omega) - target) ** 2).mean(), opt.params)
        losses.append(float(loss))
        first = grads if first is None else first
        opt.step(grads)
    return {"losses": losses, "grad": first, "params": opt.params}


def pn_steps(inputs: dict, cfg: dict, prepped: dict, n: int) -> dict:
    """The first ``n`` PerturbNet steps of the alternating phase (even
    epoch: acquisitions 0 .. n-1 in turn, the INR frozen at its initial
    weights): the loss of each step, the first gradient and the PerturbNet
    weights after the n-th step. The PerturbNet reads the encoded
    coordinates and its output is encoded again before the INR
    (superresDWI.py:140-150)."""
    omega, eps, B = cfg["omega"], cfg["pn_eps"], inputs["B"]
    ff, acq = prepped["ff"], prepped["acq_pixels"]
    inr = [p.detach() for p in inputs["inr0"]]
    opt = plain.Adam(inputs["pn0"], cfg["pn_lr"])
    losses, first = [], None
    for a in range(n):
        def loss_fn(p, a=a):
            out = plain.siren(inr, plain.fourier(plain.perturbnet(p, ff, a, eps), B), omega)
            return ((out - acq[a]) ** 2).mean()

        loss, grads = plain.loss_and_grads(loss_fn, opt.params)
        losses.append(float(loss))
        first = grads if first is None else first
        opt.step(grads)
    return {"losses": losses, "grad": first, "params": opt.params}


@torch.no_grad()
def dense_grid(inputs: dict, cfg: dict, shape, block: int = 262_144) -> torch.Tensor:
    """The INR on the dense grid of ``shape``, in blocks of rows, clamped at
    0: (prod(shape), 1) on the inputs' device."""
    coords = plain.grid(shape, inputs["B"].device)
    outs = [plain.siren(inputs["inr0"], plain.fourier(coords[i:i + block], inputs["B"]),
                        cfg["omega"]).clamp_min(0.0)
            for i in range(0, coords.shape[0], block)]
    return torch.cat(outs)
