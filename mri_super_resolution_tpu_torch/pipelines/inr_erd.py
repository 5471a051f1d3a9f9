"""Soft-ERD two-phase fine-tune: the INR_ERD.py pipeline.

Counterpart of ``mri_super_resolution_tpu/pipelines/inr_erd.py`` (``ERDCase``
:46-58, ``_phase2_fn`` :81-105, ``_recon_mean_fn`` :143-152, ``run_case``
:155-270, ``run`` :273-279; reference INR_ERD.py:162-303). Per seed and
case:

1. the Rayleigh-corrected noise level of the noise ROI (:178-181);
2. the soft-ERD weighted mean image, kept in [0, 1] (the ReLU head cannot
   emit the negatives of Normalize(0.5, 0.5));
3. phase 1: ``SirenERD(2 -> 128x3 + ReLU head)`` on that mean until the loss
   is at most ``loss_threshold``, re-initialised whenever its output
   collapses to all zero (``fit/engine.fit_until``); on a CUDA device every
   step is one K1 pass that also returns max |out|
   (``ops/siren_kernel.make_fused_value_grad_absmax``);
4. the soft-ERD per-acquisition weights;
5. phase 2: ``phase2_steps`` joint steps (one, as INR_ERD.py does) of the
   per-acquisition weighted MSE summed over the acquisitions, by autograd
   over the plain ``SirenERD`` with its perturbation on, two Adams
   (perturbation branch ``perturb_lr``, trunk ``net_lr``);
6. the mean reconstruction over the acquisitions, ADC, CNR/SNR CSV rows.

Checkpoints are ``torch.save`` of the model's ``state_dict`` (the port's
format; the JAX package writes orbax pytrees): ``<pt_id>.pt`` after phase 1
and ``<pt_id>_<seed>.pt`` after phase 2.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from mri_super_resolution_tpu_torch import resolve_device, set_float32_precision
from mri_super_resolution_tpu_torch.config import INRERDConfig
from mri_super_resolution_tpu_torch.core.adc import adc_log_ratio
from mri_super_resolution_tpu_torch.core.coords import mgrid
from mri_super_resolution_tpu_torch.core.metrics import cnr_snr_log10
from mri_super_resolution_tpu_torch.core.normalize import rayleigh_noise_std
from mri_super_resolution_tpu_torch.data import CNR_SNR_HEADER, MetricsCSV
from mri_super_resolution_tpu_torch.fit.engine import fit_until, plain_apply_init
from mri_super_resolution_tpu_torch.fit.optim import Adam
from mri_super_resolution_tpu_torch.models import SirenERD
from mri_super_resolution_tpu_torch.ops.erd import soft_erd_mean, soft_erd_weights
from mri_super_resolution_tpu_torch.ops.siren_kernel import make_fused_value_grad_absmax

PRETRAIN_MAX_STEPS = 100_000  # run_case's bound on phase 1, as the JAX package's


@dataclasses.dataclass
class ERDCase:
    """Case record for the big-image protocol (INR_ERD.py:69-95): separate
    per-b volumes instead of a single 4-D stack."""

    pt_id: str
    b: tuple[float, float, float, float]
    cancer_loc: tuple[int, int]
    contralateral_loc: tuple[int, int]
    noise: tuple[int, int]
    cancer_slice: int
    b0: np.ndarray  # (H, W, S)
    b3: np.ndarray  # (H, W, S, A) high-b acquisitions


@dataclasses.dataclass
class ERDResult:
    mean_recon: np.ndarray
    mean_orig: np.ndarray
    adc_in: np.ndarray
    adc_out: np.ndarray
    pretrain_steps: int
    params: dict  # the model's state_dict after phase 2


def acquisition_outputs(model: SirenERD, coords: torch.Tensor, acq_ids: torch.Tensor,
                        eps: float) -> torch.Tensor:
    """The perturbed model on ``coords`` (P, 2) for every acquisition id:
    (A, P, 1)."""
    A = acq_ids.shape[0]
    return model(coords.expand(A, *coords.shape), acq_ids.reshape(A, 1, 1), eps)


def phase2_step(model: SirenERD, opt_perturb: Adam, opt_net: Adam, coords: torch.Tensor,
                acq_ids: torch.Tensor, acq_targets: torch.Tensor,
                acq_weights: torch.Tensor, eps: float) -> torch.Tensor:
    """One joint step (``_phase2_fn``'s step): the sum over acquisitions of
    mean(w (out - t)^2), its gradient by autograd through the perturbation
    branch and the trunk, one update of each Adam; returns the loss."""
    perturb, net = model.perturb_params(), model.weights()
    with torch.enable_grad():
        out = acquisition_outputs(model, coords, acq_ids, eps)
        loss = torch.mean(acq_weights * (out - acq_targets) ** 2, dim=(1, 2)).sum()
        grads = torch.autograd.grad(loss, [*perturb, *net])
    opt_perturb.step(grads[:len(perturb)])
    opt_net.step(grads[len(perturb):])
    return loss.detach()


@torch.no_grad()
def recon_mean(model: SirenERD, coords: torch.Tensor, acq_ids: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Mean over the acquisitions of the perturbed model's output
    (INR_ERD.py:276-282): (P, 1)."""
    return acquisition_outputs(model, coords, acq_ids, eps).mean(dim=0)


def run_case(
    case: ERDCase,
    cfg: INRERDConfig,
    seed: int,
    models_dir: str | None = None,
    csv: MetricsCSV | None = None,
    phase2_steps: int = 1,
    device: str | torch.device = "cuda",
) -> ERDResult:
    """One case for one seed; the model is drawn from a generator seeded
    with ``seed`` (restarts draw on along it)."""
    dev = resolve_device(device)
    set_float32_precision()
    _slice = case.cancer_slice
    b = case.b[3]
    H, W = case.b0.shape[:2]
    A = case.b3.shape[3]
    dwi = torch.as_tensor(np.ascontiguousarray(case.b3[:, :, _slice, :]), dtype=torch.float32)
    b0 = torch.as_tensor(np.ascontiguousarray(case.b0[:, :, _slice]), dtype=torch.float32)

    nx, ny = case.noise
    noise_level = rayleigh_noise_std(
        torch.as_tensor(case.b3[nx - 3: nx + 2, ny - 3: ny + 2, _slice], dtype=torch.float32))
    erd_mean = soft_erd_mean(dwi, b0, noise_level, mul=cfg.soft_erd_mul,
                             slope=cfg.soft_erd_slope)

    coords = mgrid((H, W), device=dev)
    target = erd_mean.reshape(-1, 1).to(dev)
    model = SirenERD(2, cfg.hidden_features, cfg.hidden_layers, perturb=True, device=dev)
    apply_plain, init_fn = plain_apply_init(model, torch.Generator().manual_seed(seed))
    res = fit_until(apply_plain, cfg.pretrain_lr, init_fn, coords, target,
                    loss_threshold=cfg.loss_threshold, max_steps=PRETRAIN_MAX_STEPS,
                    value_grad_absmax_fn=make_fused_value_grad_absmax(model))
    if models_dir:
        torch.save(model.state_dict(), os.path.join(models_dir, f"{case.pt_id}.pt"))

    weights = soft_erd_weights(dwi, b0, noise_level, mul=cfg.soft_erd_mul,
                               slope=cfg.soft_erd_slope)
    acq_targets = dwi.permute(2, 0, 1).reshape(A, -1, 1).to(dev)
    acq_weights = weights.permute(2, 0, 1).reshape(A, -1, 1).to(dev)
    acq_ids = torch.arange(A, dtype=torch.float32, device=dev)
    eps = float(cfg.perturb_eps)
    opt_perturb = Adam(model.perturb_params(), cfg.perturb_lr)
    opt_net = Adam(model.weights(), cfg.net_lr)
    for _ in range(phase2_steps):
        phase2_step(model, opt_perturb, opt_net, coords, acq_ids, acq_targets, acq_weights,
                    eps)

    mean_recon = recon_mean(model, coords, acq_ids, eps).reshape(H, W).cpu()
    mean_orig = dwi.mean(dim=-1)
    adc_in = adc_log_ratio(mean_orig, b0, b)
    adc_out = adc_log_ratio(mean_recon, b0, b)
    if models_dir:
        torch.save(model.state_dict(), os.path.join(models_dir, f"{case.pt_id}_{seed}.pt"))

    if csv is not None:
        for img, kind, phase in ((mean_orig, "DWI", "orig"), (mean_recon, "DWI", "recon"),
                                 (adc_in, "ADC", "orig"), (adc_out, "ADC", "recon")):
            m = cnr_snr_log10(img, case.cancer_loc, case.contralateral_loc, case.noise)
            csv.append(seed, round(float(m.log10_SNRc), 3), round(float(m.log10_CNR), 3),
                       round(float(m.Sc), 3), round(float(m.Sb), 3), round(float(m.CR), 3),
                       case.pt_id, kind, phase)

    return ERDResult(mean_recon.numpy(), mean_orig.numpy(), adc_in.numpy(), adc_out.numpy(),
                     res.steps, {k: v.cpu() for k, v in model.state_dict().items()})


def run(cases: Sequence[ERDCase], cfg: INRERDConfig, out_csv: str,
        models_dir: str | None = None, device: str | torch.device = "cuda") -> str:
    csv = MetricsCSV(out_csv, CNR_SNR_HEADER)
    for seed in range(cfg.seeds):
        for case in cases:
            print(f"seed {seed} case {case.pt_id}")
            run_case(case, cfg, seed, models_dir=models_dir, csv=csv, device=device)
    return csv.path
