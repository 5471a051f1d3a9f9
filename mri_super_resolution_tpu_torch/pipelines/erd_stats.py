"""ERD-only contrast statistics (no INR): the david.py pipeline.

Counterpart of ``mri_super_resolution_tpu/pipelines/erd_stats.py`` (:1-71;
reference david.py:31-95). Per case: AutoERD acceptance (mode 1) over the
whole cancer slice, written into ``case.accept``; per direction: C and CNR
of each acquisition, the direction mean and the ERD-accepted mean, for DWI
and the two-point ADC, as CSV rows
``patient,image,direction,acquisition,metric,performance``.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from mri_super_resolution_tpu_torch import resolve_device
from mri_super_resolution_tpu_torch.core.adc import adc_log_ratio
from mri_super_resolution_tpu_torch.core.metrics import contrast_cnr
from mri_super_resolution_tpu_torch.data import Case, MetricsCSV
from mri_super_resolution_tpu_torch.ops.erd import auto_erd

EPS = 1e-7
METRICS = ("C", "CNR")
HEADER = ("patient", "image", "direction", "acquisition", "metric", "performance")


def _write_metrics(csv, case, pt_no, image_name, direction, acq, img):
    m = contrast_cnr(img, case.cancer_loc, case.contralateral_loc, case.noise, scale=1,
                     focus=0)
    for name, value in zip(METRICS, (m.C, m.CNR)):
        csv.append(pt_no, image_name, direction, acq, name, float(value))


def run(cases: Sequence[Case], out_folder: str, experiment_name: str = "david",
        device: str | torch.device = "cuda") -> str:
    """Every case's rows into ``<out_folder>/<experiment_name>.csv``; the
    masks, ADC maps and metrics are computed on ``device``."""
    dev = resolve_device(device)
    os.makedirs(out_folder, exist_ok=True)
    csv = MetricsCSV(os.path.join(out_folder, experiment_name + ".csv"), HEADER)
    directions = ["x", "y", "z"]
    for case in cases:
        pt_no = case.pt_no
        _slice = case.cancer_slice
        img_all = torch.as_tensor(np.ascontiguousarray(case.dwi[:, :, _slice, :]),
                                  dtype=torch.float32, device=dev)
        accept = auto_erd(img_all, mode=1).to(torch.float32)
        case.accept[:, :, _slice, :] = accept.cpu().numpy()
        b0 = torch.as_tensor(np.ascontiguousarray(case.b0[:, :, _slice]),
                             dtype=torch.float32, device=dev)
        b = case.b

        ends = np.cumsum(case.acquisitions)
        starts = ends - np.asarray(case.acquisitions)
        for d in range(len(case.acquisitions)):
            imgs = img_all[:, :, starts[d]: ends[d]]
            acc = accept[:, :, starts[d]: ends[d]]
            for local_a, acq in enumerate(range(starts[d], ends[d])):
                img = imgs[:, :, local_a]
                _write_metrics(csv, case, pt_no, "DWI", directions[d], acq, img)
                _write_metrics(csv, case, pt_no, "ADC", directions[d], acq,
                               adc_log_ratio(img, b0, b, mag=1000.0))

            direction_mean = imgs.mean(-1)
            accepted_mean = (imgs * acc).sum(-1) / (acc.sum(-1) + EPS)
            _write_metrics(csv, case, pt_no, "DWI", directions[d], "mean", direction_mean)
            _write_metrics(csv, case, pt_no, "ADC", directions[d], "mean",
                           adc_log_ratio(direction_mean, b0, b, mag=1000.0))
            _write_metrics(csv, case, pt_no, "DWI_ERD", directions[d], "mean", accepted_mean)
            _write_metrics(csv, case, pt_no, "ADC_ERD", directions[d], "mean",
                           adc_log_ratio(accepted_mean, b0, b, mag=1000.0))
    return csv.path
