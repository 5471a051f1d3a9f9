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

:func:`load_model` is the restore that :func:`run` and the benchmark share.
Spans (``utils/profiling.py``): ``misr.request`` around
:func:`predict_case`, and in it ``misr.draws`` (the draws, the copy of the
case's slice and b0 to the device, the gather), ``misr.forward`` (the
batched forward, clip and round), ``misr.mean`` and ``misr.adc`` (launched
on the device) and ``misr.to_host`` (the wait for the device and the one
copy back).
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
from mri_super_resolution_tpu_torch.utils.profiling import span


def build_rams(cfg: RAMSConfig, generator: torch.Generator | None = None,
               device: str | torch.device | None = None) -> RAMS:
    return RAMS(scale=cfg.scale, filters=cfg.filters, kernel_size=cfg.kernel_size,
                channels=cfg.channels, r=cfg.r, N=cfg.N, mean=cfg.mean, std=cfg.std,
                compute_dtype=cfg.compute_dtype, conv_kernel=cfg.conv_kernel,
                layout=cfg.layout, generator=generator, device=device)


def load_model(cfg: RAMSConfig, state_dict: dict,
               device: str | torch.device | None = None) -> RAMS:
    """The served network: :func:`build_rams` with ``state_dict``
    (``RAMS.state_dict()`` keys) loaded, the weight norm folded once
    (:func:`fold_weight_norm`), no gradients."""
    model = build_rams(cfg, device=device)
    model.load_state_dict(fold_weight_norm(state_dict))
    return model.requires_grad_(False)


@span("misr.request")
def predict_case(apply_fn: Callable, case: Case, cfg: RAMSConfig, sample_size: int = 25,
                 seed: int = 0, device: str | torch.device = "cuda"
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Ensemble prediction and ADC for one case (master.py:38-57):
    ``(mean_pred, adc_large)``, both (3H, 3W) numpy arrays.

    The case's slice and b0 go to the device once, the draws are gathered,
    averaged and turned into the ADC there, and both answers come back in
    one copy: the copy is the request's one wait on the device, and no
    host compute sits between two forwards."""
    with span("misr.draws"):
        rng = np.random.default_rng(seed)
        low_res = case.dwi[:, :, case.cancer_slice, :]  # (H, W, A)
        num_acq = low_res.shape[-1]
        picks = np.stack([rng.choice(num_acq, size=cfg.channels, replace=num_acq < cfg.channels)
                          for _ in range(sample_size)])  # (S, T)
        lor = torch.as_tensor(low_res.astype(np.float32), device=device) * 256.0  # uint16 range
        x = lor[:, :, torch.as_tensor(picks, device=lor.device)].permute(2, 0, 1, 3).contiguous()
        b0 = torch.as_tensor(case.b0[:, :, case.cancer_slice], dtype=torch.float32,
                             device=lor.device)
        # a divisor on the device: CUDA divides by a host scalar through its
        # reciprocal, which can round the mean a bit away from numpy's
        count = torch.full((), float(sample_size), device=lor.device)
    with span("misr.forward"):
        imgs = predict_tensor(apply_fn, x)[..., 0]  # (S, 3H, 3W), whole numbers
    with span("misr.mean"):
        # every partial sum is a whole number below 2^24 for fewer than 256
        # draws, so exact in float32 in any order
        mean_pred = imgs.sum(dim=0) / count
    with span("misr.adc"):
        adc_large = adc_log_ratio(mean_pred, rescale(b0, cfg.scale), case.b, mag=1e6)
    with span("misr.to_host"):
        out = torch.stack([mean_pred, adc_large]).cpu().numpy()
    return out[0], out[1]


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
    model = load_model(cfg, state_dict, dev)
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
