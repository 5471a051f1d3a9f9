"""Synthetic half-resolution quality protocol: the superres-lowres.ipynb
pipeline.

Counterpart of ``mri_super_resolution_tpu/pipelines/lowres_qual.py``
(``_metric_table`` :50, ``LowresQualConfig`` :63, ``run_slice`` :97-202,
``run`` :205-231; reference superres-lowres.ipynb cells 6-19 and
superres-lowres-qual.ipynb cell 6). Per case and slice:

1. ground truth: the full-resolution mean over the high-b acquisitions
   (with ``split_protocol``, over the held-out second half; the inputs see
   only the first half, so the truth's noise is independent of both arms);
2. LR: the anti-aliased 0.5x ``rescale`` of the input mean, which shares no
   noise realisation with the truth;
3. phase 1: ``SirenERD(2 -> 128x3 + ReLU head)`` on the LR mean until the
   loss is at most ``loss_threshold``, re-initialised on collapse
   (``fit/engine.fit_until``); on a CUDA device every step is one K1-a pass
   (``ops/siren_kernel.make_fused_value_grad_absmax``), at the LR slice's
   h x w rows;
4. soft-ERD per-acquisition weights on the downsampled acquisitions, the b0
   divided by the same scale as the acquisitions;
5. phase 2: ``phase2_steps`` joint steps of ``pipelines/inr_erd.phase2_step``
   with two fresh Adams (perturbation branch ``perturb_lr``, trunk
   ``net_lr``), as the JAX package's ``_finetune_scan_fn`` starts its Adam
   state from zero in every slice;
6. SR: the mean over the acquisitions of the perturbed INR on the
   full-resolution grid; the spline baseline is ``rescale(LR, 2)``;
7. masked SSIM (the Gourdeau protocol) and PSNR of both against the truth.

CSV schema: pt_id, slice, ssim_spline, ssim_sr, psnr_spline, psnr_sr (SSIM
rounded to 5 places, PSNR to 3).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from mri_super_resolution_tpu_torch import resolve_device, set_float32_precision
from mri_super_resolution_tpu_torch.core.coords import mgrid
from mri_super_resolution_tpu_torch.core.interp import rescale
from mri_super_resolution_tpu_torch.core.metrics import masked_ssim_protocol, psnr
from mri_super_resolution_tpu_torch.core.normalize import rayleigh_noise_std
from mri_super_resolution_tpu_torch.data import MetricsCSV
from mri_super_resolution_tpu_torch.fit.engine import fit_until, plain_apply_init
from mri_super_resolution_tpu_torch.fit.optim import Adam
from mri_super_resolution_tpu_torch.models import SirenERD
from mri_super_resolution_tpu_torch.ops.erd import soft_erd_weights
from mri_super_resolution_tpu_torch.ops.siren_kernel import make_fused_value_grad_absmax
from mri_super_resolution_tpu_torch.pipelines.inr_erd import ERDCase, phase2_step, recon_mean

LOWRES_QUAL_HEADER = ("pt_id", "slice", "ssim_spline", "ssim_sr", "psnr_spline", "psnr_sr")


@dataclasses.dataclass
class LowresQualConfig:
    hidden_features: int = 128
    hidden_layers: int = 3
    pretrain_lr: float = 3e-4  # cell 6
    loss_threshold: float = 2e-5  # cell 7
    phase2_steps: int = 500  # cell 12 ("if ctr > 500: break")
    perturb_lr: float = 1e-5  # cell 12 optim1
    net_lr: float = 1e-7  # cell 12 optim2
    perturb_eps: float = 1.0 / 128.0
    soft_erd_mul: float = 1000.0
    soft_erd_slope: float = 20.0
    max_pretrain_steps: int = 100_000
    # ground truth from a held-out half of the acquisitions, the inputs
    # from the other half (see the JAX package's config for the confound
    # this removes)
    split_protocol: bool = False


@dataclasses.dataclass
class LowresQualResult:
    gt: np.ndarray  # (H, W) ground-truth mean
    lr: np.ndarray  # (H/2, W/2)
    spline: np.ndarray  # (H, W)
    sr: np.ndarray  # (H, W)
    metrics: tuple  # (ssim_spline, ssim_sr, psnr_spline, psnr_sr)
    pretrain_steps: int


def _metric_table(gt_im: torch.Tensor, sp_im: torch.Tensor, sr_im: torch.Tensor) -> tuple:
    return tuple(float(m) for m in (
        masked_ssim_protocol(gt_im, sp_im), masked_ssim_protocol(gt_im, sr_im),
        psnr(gt_im, sp_im, data_range=1.0), psnr(gt_im, sr_im, data_range=1.0)))


def _half(img: np.ndarray) -> torch.Tensor:
    """The anti-aliased 0.5x downsample of the last two axes, in float32."""
    return rescale(torch.as_tensor(np.ascontiguousarray(img), dtype=torch.float32), 0.5,
                   anti_aliasing=True)


def run_slice(case: ERDCase, _slice: int, cfg: LowresQualConfig, seed: int = 0,
              device: str | torch.device = "cuda") -> LowresQualResult:
    """One case and slice; the model is drawn from a generator seeded with
    ``seed`` (restarts draw on along it). The images are prepared and
    scored on the CPU, the fits and the SR run on ``device``."""
    dev = resolve_device(device)
    set_float32_precision()
    dwi = case.b3[:, :, _slice, :]  # (H, W, A)
    b0 = case.b0[:, :, _slice]
    if cfg.split_protocol:
        A_all = dwi.shape[-1]
        gt = dwi[..., A_all // 2:].mean(-1)
        dwi = dwi[..., : A_all // 2]
        input_mean = dwi.mean(-1)
    else:
        gt = dwi.mean(-1)
        input_mean = gt  # the reference protocol: LR derives from the truth itself
    H, W, A = dwi.shape
    scale = float(gt.max()) + 1e-12
    gt_n = gt / scale

    lr = _half(input_mean / scale)
    h, w = lr.shape
    # fit in [0, 1], not the reference's Normalize(0.5, 0.5): the ReLU output
    # cannot reach negative targets, and the threshold loop would not end
    coords_lr = mgrid((h, w), device=dev)
    target = lr.reshape(-1, 1).to(dev)
    model = SirenERD(2, cfg.hidden_features, cfg.hidden_layers, perturb=True, device=dev)
    apply_plain, init_fn = plain_apply_init(model, torch.Generator().manual_seed(seed))
    res = fit_until(apply_plain, cfg.pretrain_lr, init_fn, coords_lr, target,
                    loss_threshold=cfg.loss_threshold, max_steps=cfg.max_pretrain_steps,
                    value_grad_absmax_fn=make_fused_value_grad_absmax(model))

    nx, ny = case.noise
    noise_level = rayleigh_noise_std(torch.as_tensor(
        case.b3[nx - 3: nx + 2, ny - 3: ny + 2, _slice] / scale, dtype=torch.float32))
    acq_low = _half(np.moveaxis(dwi / scale, -1, 0))  # (A, h, w)
    # the b0 in the acquisitions' units: soft_erd_weights' temperature reads
    # the x_mean / b0 ratio
    b0_low = _half(b0 / scale)
    weights = soft_erd_weights(acq_low.permute(1, 2, 0), b0_low, noise_level,
                               mul=cfg.soft_erd_mul, slope=cfg.soft_erd_slope)
    acq_targets = acq_low.reshape(A, -1, 1).to(dev)
    acq_weights = weights.permute(2, 0, 1).reshape(A, -1, 1).to(dev)
    acq_ids = torch.arange(A, dtype=torch.float32, device=dev)
    eps = float(cfg.perturb_eps)
    opt_perturb = Adam(model.perturb_params(), cfg.perturb_lr)
    opt_net = Adam(model.weights(), cfg.net_lr)
    for _ in range(int(cfg.phase2_steps)):
        phase2_step(model, opt_perturb, opt_net, coords_lr, acq_ids, acq_targets, acq_weights,
                    eps)

    sr = recon_mean(model, mgrid((H, W), device=dev), acq_ids, eps).reshape(H, W).cpu()
    spline = rescale(lr, 2, anti_aliasing=True)
    metrics = _metric_table(torch.as_tensor(gt_n, dtype=torch.float32), spline, sr)
    return LowresQualResult(gt=gt_n, lr=lr.numpy(), spline=spline.numpy(), sr=sr.numpy(),
                            metrics=metrics, pretrain_steps=res.steps)


def append_row(csv: MetricsCSV, pt_id: str, _slice: int, metrics: tuple) -> None:
    """One CSV row of the schema, SSIM rounded to 5 places, PSNR to 3."""
    ssim_sp, ssim_sr, psnr_sp, psnr_sr = metrics
    csv.append(pt_id, _slice, round(ssim_sp, 5), round(ssim_sr, 5), round(psnr_sp, 3),
               round(psnr_sr, 3))


def run(cases: Sequence[ERDCase], cfg: LowresQualConfig, out_csv: str,
        slices: Sequence[int] | None = None, seed: int = 0,
        device: str | torch.device = "cuda") -> str:
    """Sweep cases x slices (superres-lowres-qual.ipynb cell 6) into the
    CSV; slices past a case's depth are skipped."""
    csv = MetricsCSV(out_csv, LOWRES_QUAL_HEADER)
    for case in cases:
        case_slices = slices if slices is not None else range(case.b3.shape[2])
        for _slice in case_slices:
            if _slice >= case.b3.shape[2]:
                continue
            res = run_slice(case, _slice, cfg, seed=seed, device=device)
            append_row(csv, case.pt_id, _slice, res.metrics)
            ssim_sp, ssim_sr, psnr_sp, psnr_sr = res.metrics
            print(f"{case.pt_id} slice {_slice}: SSIM spline {ssim_sp:.4f} vs "
                  f"SR {ssim_sr:.4f} | PSNR spline {psnr_sp:.2f} vs SR {psnr_sr:.2f} "
                  f"({res.pretrain_steps} pretrain steps)")
    return csv.path
