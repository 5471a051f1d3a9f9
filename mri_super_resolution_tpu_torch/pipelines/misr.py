"""Multi-image super-resolution inference: the MISR master.py pipeline.

Counterpart of ``mri_super_resolution_tpu/pipelines/misr.py`` (reference:
multi-image-super-resolution/master.py:29-68). Per case: take the cancer
slice's acquisition stack, scale it to the uint16 range (x256), draw
``sample_size`` random 9-acquisition subsets with numpy (the same draws as
the JAX package for the same seed), predict all of them in one batched RAMS
forward, average; compute the 3x ADC against the rescaled b0 (x 1e6);
write DWI and ADC DICOMs and ``timings.json``.

With ``RAMSConfig.conv_kernel`` the RAMS 3x3x3 convs with 32 channels run
K6 on a CUDA device: ``2 N + 1 + 3 (T // 3)`` launches per forward (34 at
the reference architecture).
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Sequence

import numpy as np
import torch

from mri_super_resolution_tpu_torch import resolve_device, set_float32_precision
from mri_super_resolution_tpu_torch.config import RAMSConfig
from mri_super_resolution_tpu_torch.core.adc import adc_log_ratio
from mri_super_resolution_tpu_torch.core.interp import rescale
from mri_super_resolution_tpu_torch.data import Case, save_dicom
from mri_super_resolution_tpu_torch.models.rams import RAMS, fold_weight_norm
from mri_super_resolution_tpu_torch.ops.tta import predict_tensor


def build_rams(cfg: RAMSConfig, generator: torch.Generator | None = None,
               device: str | torch.device | None = None) -> RAMS:
    return RAMS(scale=cfg.scale, filters=cfg.filters, kernel_size=cfg.kernel_size,
                channels=cfg.channels, r=cfg.r, N=cfg.N, mean=cfg.mean, std=cfg.std,
                compute_dtype=cfg.compute_dtype, conv_kernel=cfg.conv_kernel,
                generator=generator, device=device)


def predict_case(apply_fn: Callable, case: Case, cfg: RAMSConfig, sample_size: int = 25,
                 seed: int = 0, device: str | torch.device = "cuda"
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Ensemble prediction and ADC for one case (master.py:38-57):
    ``(mean_pred, adc_large)``, both (3H, 3W) numpy arrays."""
    rng = np.random.default_rng(seed)
    low_res = case.dwi[:, :, case.cancer_slice, :]  # (H, W, A)
    num_acq = low_res.shape[-1]
    lor = low_res.astype(np.float32) * 256.0  # uint16 range
    stack = np.stack(
        [lor[..., rng.choice(num_acq, size=cfg.channels, replace=num_acq < cfg.channels)]
         for _ in range(sample_size)], axis=0)  # (S, H, W, T)
    imgs = predict_tensor(apply_fn, torch.as_tensor(stack, device=device))[..., 0]
    mean_pred = imgs.cpu().numpy().mean(axis=0)

    b0 = torch.as_tensor(case.b0[:, :, case.cancer_slice], dtype=torch.float32)
    adc_large = adc_log_ratio(torch.as_tensor(mean_pred), rescale(b0, cfg.scale),
                              case.b, mag=1e6).numpy()
    return mean_pred, adc_large


def run(cases: Sequence[Case], cfg: RAMSConfig, state_dict: dict, out_img_folder: str,
        exp_name: str = "sr2", sample_size: int = 25, seed: int = 0,
        device: str | torch.device = "cuda") -> None:
    """Serve ``state_dict`` (``RAMS.state_dict()`` keys) on every case: the
    weight norm is folded once at restore, each case is one batched forward
    under ``torch.inference_mode``. ``timings.json`` holds per-case
    ``predict_s`` (host clock around the forward and its copy to the host;
    the first case includes the K6 build when it has not happened yet),
    ``write_s`` and ``draws``."""
    dev = resolve_device(device)
    set_float32_precision()
    model = build_rams(cfg, device=dev)
    model.load_state_dict(fold_weight_norm(state_dict))
    model.requires_grad_(False)
    timings = []
    with torch.inference_mode():
        for case in cases:
            t0 = time.perf_counter()
            mean_pred, adc_large = predict_case(model, case, cfg, sample_size, seed, dev)
            t1 = time.perf_counter()
            base = os.path.join(out_img_folder, exp_name, case.pt_no)
            save_dicom(mean_pred, os.path.join(base, "DWI", "mean.dcm"))
            save_dicom(adc_large, os.path.join(base, "ADC", "mean.dcm"))
            timings.append({"pt_no": case.pt_no, "predict_s": t1 - t0,
                            "write_s": time.perf_counter() - t1, "draws": sample_size})
    os.makedirs(os.path.join(out_img_folder, exp_name), exist_ok=True)
    with open(os.path.join(out_img_folder, exp_name, "timings.json"), "w") as f:
        json.dump({"platform": dev.type,
                   "device_name": (torch.cuda.get_device_name(dev)
                                   if dev.type == "cuda" else "cpu"),
                   "filters": cfg.filters, "N": cfg.N, "conv_kernel": cfg.conv_kernel,
                   "cases": timings}, f, indent=1)
