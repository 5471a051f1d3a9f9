"""Blinded qualitative-study panels and their perceptual scoring.

Counterpart of ``mri_super_resolution_tpu/pipelines/qual_study.py``
(``QualPanel``, ``ARMS``, ``build_panel`` :59-143, ``save_panel``, ``run``,
``score_panels`` :205-224; reference prepare_qual_images.py:139-301 and
perceptual_similarity.m). Per case and slice, on ``device``:

1. the "low" arm: the anti-aliased 0.5x ``rescale`` of the acquisition mean;
   a ``SirenERD(2 -> 128x3 + ReLU head)`` fitted to it until the loss is at
   most ``loss_threshold``, re-initialised on collapse
   (``fit/engine.fit_until``); on a CUDA device every step is one K1-a pass
   on its streaming route (``ops/siren_kernel.make_fused_value_grad_absmax``);
2. soft-ERD weights on the downsampled acquisitions (the noise level from
   the slice's noise ROI), then ``fine_tune_steps`` joint steps of
   ``pipelines/inr_erd.phase2_step`` with two fresh Adams (perturbation
   branch 1e-5, trunk 1e-7);
3. the "SR" arm: the perturb-averaged INR on the full-resolution grid;
4. the "interpolated" arm (``rescale(low, 2)``), the "base" arm (the
   full-resolution mean) and the four ADC maps;
5. the column order: ``numpy.random.default_rng(seed).permutation(ARMS)``.

``save_panel`` draws the blinded 2 x 4 PNG with matplotlib (imported inside
it; the card's machine has none). ``score_panels`` replaces the MATLAB
analysis with ``ops/perceptual.score_panel``.
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
from mri_super_resolution_tpu_torch.core.interp import rescale
from mri_super_resolution_tpu_torch.core.normalize import rayleigh_noise_std
from mri_super_resolution_tpu_torch.data import MetricsCSV
from mri_super_resolution_tpu_torch.fit.engine import fit_until, plain_apply_init
from mri_super_resolution_tpu_torch.fit.optim import Adam
from mri_super_resolution_tpu_torch.models import SirenERD
from mri_super_resolution_tpu_torch.ops.erd import soft_erd_weights
from mri_super_resolution_tpu_torch.ops.perceptual import SCORE_KEYS, score_panel
from mri_super_resolution_tpu_torch.ops.siren_kernel import make_fused_value_grad_absmax
from mri_super_resolution_tpu_torch.pipelines.inr_erd import (
    PRETRAIN_MAX_STEPS,
    ERDCase,
    phase2_step,
    recon_mean,
)

ARMS = ("low", "interpolated", "SR", "base")
PERTURB_LR, NET_LR = 1e-5, 1e-7  # the fine-tune's two Adams (JAX :118-120)
LABELS_HEADER = ("file", "pt", "image", "1", "2", "3", "4")


@dataclasses.dataclass
class QualPanel:
    low: np.ndarray
    interpolated: np.ndarray
    sr: np.ndarray
    base: np.ndarray
    adc_low: np.ndarray
    adc_interpolated: np.ndarray
    adc_sr: np.ndarray
    adc_base: np.ndarray
    order: tuple  # shuffled column -> arm name


def _half(img: torch.Tensor) -> torch.Tensor:
    return rescale(img, 0.5, anti_aliasing=True)


def build_panel(case: ERDCase, _slice: int, cfg: INRERDConfig | None = None, seed: int = 0,
                fine_tune_steps: int = 500, device: str | torch.device = "cuda") -> QualPanel:
    """One blinded panel of ``case`` at ``_slice``; the model is drawn from a
    generator seeded with ``seed`` (restarts draw on along it)."""
    cfg = cfg or INRERDConfig()
    dev = resolve_device(device)
    set_float32_precision()
    rng = np.random.default_rng(seed)
    b = case.b[3]

    def as_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    b0 = as_dev(case.b0[:, :, _slice])
    dwi = as_dev(case.b3[:, :, _slice, :])
    H, W, A = dwi.shape

    base = dwi.mean(dim=-1)
    img_low = _half(base)
    h, w = img_low.shape
    b0_low = _half(b0)

    # a [0, 1] target, not Normalize(0.5, 0.5): the ReLU head cannot reach
    # a negative background (the deviation of inr_erd.py / lowres_qual.py)
    coords = mgrid((h, w), device=dev)
    model = SirenERD(2, cfg.hidden_features, cfg.hidden_layers, perturb=True, device=dev)
    apply_plain, init_fn = plain_apply_init(model, torch.Generator().manual_seed(seed))
    fit_until(apply_plain, cfg.pretrain_lr, init_fn, coords, img_low.reshape(-1, 1),
              loss_threshold=cfg.loss_threshold, max_steps=PRETRAIN_MAX_STEPS,
              value_grad_absmax_fn=make_fused_value_grad_absmax(model))

    # soft-ERD weights on the half-res acquisitions (prepare_qual_images.py:
    # 205-219), the noise ROI of the slice being processed
    nx, ny = case.noise
    noise_level = rayleigh_noise_std(as_dev(case.b3[nx - 3: nx + 2, ny - 3: ny + 2, _slice]))
    low_acqs = _half(dwi.permute(2, 0, 1))  # (A, h, w)
    weights = soft_erd_weights(low_acqs.permute(1, 2, 0), b0_low, noise_level,
                               mul=cfg.soft_erd_mul, slope=cfg.soft_erd_slope)
    acq_targets = low_acqs.reshape(A, -1, 1)
    acq_weights = weights.permute(2, 0, 1).reshape(A, -1, 1)
    acq_ids = torch.arange(A, dtype=torch.float32, device=dev)
    eps = float(cfg.perturb_eps)
    opt_perturb = Adam(model.perturb_params(), PERTURB_LR)
    opt_net = Adam(model.weights(), NET_LR)
    for _ in range(fine_tune_steps):
        phase2_step(model, opt_perturb, opt_net, coords, acq_ids, acq_targets, acq_weights, eps)

    # full-resolution reconstruction, perturb-averaged (prepare_qual_images.py:268-275)
    sr = recon_mean(model, mgrid((H, W), device=dev), acq_ids, eps).reshape(H, W)
    interpolated = rescale(img_low, 2, anti_aliasing=True)
    b0_up = rescale(b0_low, 2, anti_aliasing=True)

    def calc(img, bb):
        return adc_log_ratio(img, bb, b, mag=1000.0).cpu().numpy()

    host = lambda t: t.cpu().numpy()  # noqa: E731
    return QualPanel(
        low=host(img_low), interpolated=host(interpolated), sr=host(sr), base=host(base),
        adc_low=calc(img_low, b0_low), adc_interpolated=calc(interpolated, b0_up),
        adc_sr=calc(sr, b0_up), adc_base=calc(base, b0),
        order=tuple(rng.permutation(ARMS)))


def save_panel(panel: QualPanel, path: str, roi=(35, 95)) -> dict:
    """Write the blinded 2 x 4 PNG; returns the labels.csv row dict."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    arm_imgs = {
        "low": (panel.low, panel.adc_low),
        "interpolated": (panel.interpolated, panel.adc_interpolated),
        "SR": (panel.sr, panel.adc_sr),
        "base": (panel.base, panel.adc_base),
    }
    r0, r1 = roi
    fig, axes = plt.subplots(2, 4, figsize=(24, 12))
    row = {}
    for col, arm in enumerate(panel.order):
        img, adc = arm_imgs[arm]
        crop = slice(r0 // 2, r1 // 2) if img.shape[0] < 128 else slice(r0, r1)
        axes[0][col].imshow(img, cmap="gray")
        axes[1][col].imshow(adc[crop, crop], cmap="gray", vmin=0, vmax=3)
        axes[0][col].axis("off")
        axes[1][col].axis("off")
        row[str(col + 1)] = arm
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)
    return row


def run(cases: Sequence[ERDCase], out_dir: str = "qual", slices_per_case: int | None = None,
        seed: int = 0, start_counter: int = 291, fine_tune_steps: int = 500,
        device: str | torch.device = "cuda") -> tuple[str, dict[int, QualPanel]]:
    """The prep loop (prepare_qual_images.py:139-301): ``<counter>.png``
    panels and labels.csv under ``out_dir``, slices drawn with
    ``default_rng(seed)``. Returns the labels.csv path and the panels by
    counter (``score_panels`` takes them; the JAX package's ``run`` returns
    the path only)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    csv = MetricsCSV(os.path.join(out_dir, "labels.csv"), LABELS_HEADER)
    counter = start_counter
    panels = {}
    for case in cases:
        S = case.b3.shape[2]
        for _slice in rng.permutation(S)[: slices_per_case or S]:
            panel = build_panel(case, int(_slice), seed=counter,
                                fine_tune_steps=fine_tune_steps, device=device)
            row = save_panel(panel, os.path.join(out_dir, f"{counter}.png"))
            csv.append(counter, case.pt_id, int(_slice), row["1"], row["2"], row["3"], row["4"])
            panels[counter] = panel
            counter += 1
    return csv.path, panels


def score_panels(panels: dict[int, QualPanel], out_csv: str,
                 device: str | torch.device = "cuda") -> str:
    """Perceptual scoring of prepared panels on ``device``: the
    perceptual_similarity.m analysis, each quadrant scaled by 255 over the
    base arm's maximum, every score rounded to 5 places. With no panels the
    CSV still gets the populated schema's header."""
    dev = resolve_device(device)
    csv = MetricsCSV(out_csv, ("file",) + SCORE_KEYS)
    for counter, panel in sorted(panels.items()):
        peak = panel.base.max() + 1e-7
        scores = score_panel(HR=panel.base * 255.0 / peak,
                             interp=panel.interpolated * 255.0 / peak,
                             SR=panel.sr * 255.0 / peak, device=dev)
        csv.append(counter, *[round(v, 5) for v in scores.values()])
    return out_csv
