"""2-D directional ensemble super-resolution: the master.py pipeline.

Counterpart of ``mri_super_resolution_tpu/pipelines/master2d.py``
(reference: implicit-neural-representations/master.py:54-263). Per seed and
case: optional AutoERD acceptance mask; per gradient direction (x, y, z) a
Siren(2 -> 64x6) fit with the acceptance-weighted MSE for ``total_steps``
steps of one Adam update per acquisition, the last ``seg`` steps' dense-grid
predictions at 1x and scale-x averaged; normalise; ADC (log-ratio); contrast
metrics -> CSV; across-direction means -> DICOM.

The JAX package vmaps the three directions into one padded fit, and so
does the port: the directions are D stacked Sirens, each step runs the
acquisition slots a = 0 .. A_max - 1, and each slot is one batched update
of every direction (``fit/engine.fit_ensemble_batched``); a direction with
fewer acquisitions than A_max has padded slots that leave its params and
Adam state untouched (``fit/optim.StackedAdam``'s mask). On a CUDA device
every such update is one batched K1 pass with sample weights
(``ops/siren_kernel.make_fused_weighted_value_and_grad_batched``: the
weight-resident kernel over the three directions); the tail's dense
evaluations are a plain batched forward, as they are XLA in the JAX
package.

Kept from the JAX package (a documented deviation from the reference): the
direction-mean DICOMs and CSV rows average the three directions; the
reference's accumulation block doubles the last direction instead
(master.py:197-223).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from mri_super_resolution_tpu_torch import resolve_device, set_float32_precision
from mri_super_resolution_tpu_torch.config import Master2DConfig
from mri_super_resolution_tpu_torch.core.adc import adc_log_ratio
from mri_super_resolution_tpu_torch.core.coords import mgrid
from mri_super_resolution_tpu_torch.core.interp import rescale
from mri_super_resolution_tpu_torch.core.metrics import contrast_cnr, minmax_normalize
from mri_super_resolution_tpu_torch.core.normalize import to_tensor_normalize
from mri_super_resolution_tpu_torch.data import CONTRAST_HEADER, Case, MetricsCSV, save_dicom
from mri_super_resolution_tpu_torch.fit.engine import fit_ensemble_batched
from mri_super_resolution_tpu_torch.fit.optim import StackedAdam
from mri_super_resolution_tpu_torch.models import Siren
from mri_super_resolution_tpu_torch.ops.erd import auto_erd
from mri_super_resolution_tpu_torch.ops.siren_kernel import (
    make_fused_weighted_value_and_grad_batched,
    siren_forward_batched_ref,
)

METRIC_NAMES = ("C", "CNR", "CNR2")
EPS = 1e-7
MAG = 1000.0


@dataclasses.dataclass
class DirectionOutputs:
    """Per-direction images keyed like the reference's ``images`` dict
    (master.py:180-188)."""

    mean: np.ndarray
    erd: np.ndarray
    superres: np.ndarray
    superres_n: np.ndarray
    large: np.ndarray
    large_n: np.ndarray
    adc_orig: np.ndarray
    adc_erd: np.ndarray
    adc_super: np.ndarray
    adc_super_norm: np.ndarray
    adc_large: np.ndarray
    adc_large_norm: np.ndarray

    def metric_images(self) -> dict[str, np.ndarray]:
        return {
            "mean": self.mean,
            "ERD": self.erd,
            "superres": self.superres,
            "superres_n": self.superres_n,
            "ADC_orig": self.adc_orig,
            "ADC_ERD": self.adc_erd,
            "ADC_super": self.adc_super,
            "ADC_super_norm": self.adc_super_norm,
        }


def _direction_slices(acquisitions: Sequence[int]) -> list[tuple[int, int]]:
    ends = np.cumsum(acquisitions)
    starts = ends - np.asarray(acquisitions)
    return [(int(s), int(e)) for s, e in zip(starts, ends)]


def _check_route(cfg: Master2DConfig, device) -> None:
    if not cfg.use_pallas and torch.device(device).type == "cuda":
        raise ValueError("use_pallas=False: the port has no plain route on the card; "
                         "its per-acquisition updates always run K1 there")


def fit_directions(
    roi_dwi: np.ndarray,  # (H, W, A_total) ROI crop of the cancer slice
    accept: np.ndarray,  # (H, W, A_total) acceptance mask
    acquisitions: Sequence[int],
    cfg: Master2DConfig,
    seed: int,
    device: str | torch.device = "cuda",
    params_stack: Sequence[Sequence[torch.Tensor]] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Fit every gradient direction on its own acquisitions, the D
    directions in one batched fit (the JAX package's vmapped one). Returns
    (pred_1x [D, H, W], pred_scale [D, H s, W s]) ensemble means in
    Normalize(0.5, 0.5) space.

    Directions with fewer acquisitions than the most are padded with
    zero-weight slots marked invalid, which leave that direction's params
    and Adam state (its update count included) untouched, as the reference's
    per-direction loop leaves them.

    ``params_stack`` gives each direction's initial weights (``Siren.weights()``
    order; ``convert.siren_stack_weights`` of the JAX package's vmapped init);
    without it the D models are drawn in turn from a generator seeded with
    ``seed``."""
    _check_route(cfg, device)
    dev = resolve_device(device)
    set_float32_precision()
    H, W, _ = roi_dwi.shape
    D, A_max, P = len(acquisitions), max(acquisitions), H * W
    coords = mgrid((H, W), device=dev)
    coords_s = mgrid((H * cfg.scale, W * cfg.scale), device=dev)
    gen = torch.Generator().manual_seed(seed)
    models = [Siren(2, cfg.hidden_features, cfg.hidden_layers, 1, generator=gen)
              for _ in range(D)]
    inits = ([m.weights() for m in models] if params_stack is None
             else [list(p) for p in params_stack])
    stacked = [torch.stack([w[i].detach() for w in inits]).to(dev)
               for i in range(len(inits[0]))]

    pixels = np.zeros((D, A_max, P, 1), dtype=np.float32)
    weights = np.zeros((D, A_max, P, 1), dtype=np.float32)
    valid = np.zeros((D, A_max), dtype=bool)
    for d, (s, e) in enumerate(_direction_slices(acquisitions)):
        for i, a in enumerate(range(s, e)):
            pixels[d, i, :, 0] = to_tensor_normalize(roi_dwi[:, :, a]).reshape(-1)
            weights[d, i, :, 0] = accept[:, :, a].reshape(-1)
        valid[d, :e - s] = True
    omegas = models[0].omegas

    def apply_fn(params, x):
        return siren_forward_batched_ref(x, params, omegas)

    res = fit_ensemble_batched(
        apply_fn, StackedAdam(stacked, cfg.learning_rate), coords,
        torch.as_tensor(pixels, device=dev), torch.as_tensor(weights, device=dev), coords,
        coords_s, total_steps=cfg.total_steps, seg=cfg.seg, valid=valid,
        weighted_value_and_grad_fn=(make_fused_weighted_value_and_grad_batched(models[0])
                                    if cfg.use_pallas else None))
    return (res.pred_1x.reshape(D, H, W).cpu().numpy(),
            res.pred_scale.reshape(D, H * cfg.scale, W * cfg.scale).cpu().numpy())


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def run_case(
    case: Case,
    cfg: Master2DConfig,
    seed: int,
    csv: MetricsCSV | None = None,
    device: str | torch.device = "cuda",
    params_stack: Sequence[Sequence[torch.Tensor]] | None = None,
) -> dict[str, DirectionOutputs]:
    """One case for one seed: per-direction outputs ('x', 'y', 'z') and, with
    ``csv``, their metric rows. AutoERD (``cfg.erd``) writes its mask into
    ``case.accept``, as the reference does."""
    r0, r1 = cfg.roi_begin, cfg.roi_end
    _slice = case.cancer_slice
    b0 = case.b0[r0:r1, r0:r1, _slice]
    roi_dwi = case.dwi[r0:r1, r0:r1, _slice, :]
    accept = case.accept[r0:r1, r0:r1, _slice, :].astype(np.float32)

    if cfg.erd:
        dev = resolve_device(device)
        erd_map = (torch.as_tensor(case.erd[r0:r1, r0:r1, _slice], device=dev)
                   if cfg.erd == 2 else None)
        accept = auto_erd(torch.as_tensor(np.ascontiguousarray(roi_dwi), device=dev),
                          erd_map, mode=cfg.erd).cpu().numpy().astype(np.float32)
        case.accept[r0:r1, r0:r1, _slice, :] = accept

    pred_1x, pred_s = fit_directions(roi_dwi, accept, case.acquisitions, cfg, seed,
                                     device, params_stack)

    outputs: dict[str, DirectionOutputs] = {}
    b0_t = _t(b0)
    b0_scaled = rescale(b0_t, cfg.scale)

    def calc(img, bb):
        return adc_log_ratio(_t(img), bb, case.b, mag=MAG * MAG).numpy()

    for d, name in enumerate(("x", "y", "z")[: len(case.acquisitions)]):
        s, e = _direction_slices(case.acquisitions)[d]
        imgs = roi_dwi[:, :, s:e]
        acc = accept[:, :, s:e]
        direction_mean = imgs.mean(-1)
        accepted_mean = (imgs * acc).sum(-1) / (acc.sum(-1) + EPS)

        out_img = pred_1x[d] - pred_1x[d].min()
        large_out = pred_s[d] - pred_s[d].min()
        norm_out = minmax_normalize(_t(out_img), _t(direction_mean)).numpy()
        norm_large = minmax_normalize(_t(large_out), _t(direction_mean)).numpy()
        out = DirectionOutputs(
            mean=direction_mean,
            erd=accepted_mean,
            superres=out_img,
            superres_n=norm_out,
            large=large_out,
            large_n=norm_large,
            adc_orig=calc(direction_mean, b0_t),
            adc_erd=calc(accepted_mean, b0_t),
            adc_super=calc(out_img, b0_t),
            adc_super_norm=calc(norm_out, b0_t),
            adc_large=calc(large_out, b0_scaled),
            adc_large_norm=calc(norm_large, b0_scaled),
        )
        outputs[name] = out
        if csv is not None:
            _metric_rows(csv, seed, case, cfg, name, out)
    return outputs


def _metric_rows(csv: MetricsCSV, seed: int, case: Case, cfg: Master2DConfig,
                 direction: str, out: DirectionOutputs) -> None:
    for img_name, img in out.metric_images().items():
        m = contrast_cnr(_t(img), case.cancer_loc, case.contralateral_loc, case.noise,
                         scale=1, focus=cfg.roi_begin)
        for metric_name, value in zip(METRIC_NAMES, m):
            csv.append(seed, case.pt_no, direction, img_name, metric_name, float(value))


def save_case_outputs(
    outputs: dict[str, DirectionOutputs],
    case: Case,
    cfg: Master2DConfig,
    seed: int,
    csv: MetricsCSV | None = None,
) -> None:
    """Across-direction means -> DICOM files and 'mean' CSV rows
    (master.py:212-262, with the JAX package's direction mean)."""
    fields = [f.name for f in dataclasses.fields(DirectionOutputs)]
    mean = DirectionOutputs(
        **{f: np.mean([getattr(o, f) for o in outputs.values()], axis=0) for f in fields})
    base = os.path.join(cfg.out_img_folder, cfg.exp_name, case.pt_no)
    dwi_files = {
        "mean.dcm": mean.mean * MAG,
        "erd.dcm": mean.erd * MAG,
        "super.dcm": mean.large * MAG,
        "super_norm.dcm": mean.large_n * MAG,
    }
    adc_files = {
        "mean.dcm": mean.adc_orig,
        "erd.dcm": mean.adc_erd,
        "super.dcm": mean.adc_super,
        "large.dcm": mean.adc_large,
        "norm_super.dcm": mean.adc_super_norm,
        "norm_super_large.dcm": mean.adc_large_norm,
    }
    for fname, img in dwi_files.items():
        save_dicom(img, os.path.join(base, "DWI", fname))
    for fname, img in adc_files.items():
        save_dicom(img, os.path.join(base, "ADC", fname))
    if csv is not None:
        _metric_rows(csv, seed, case, cfg, "mean", mean)


def run(cfg: Master2DConfig, cases: list[Case], device: str | torch.device = "cuda") -> str:
    """The master.py main loop, seeds x cases. Returns the CSV path."""
    _check_route(cfg, device)
    os.makedirs(cfg.out_folder, exist_ok=True)
    csv = MetricsCSV(os.path.join(cfg.out_folder, cfg.exp_name + ".csv"), CONTRAST_HEADER)
    for seed in range(cfg.repeat_time):
        for case in cases:
            print(f"seed {seed} case {case.pt_id}")
            outputs = run_case(case, cfg, seed, csv, device)
            save_case_outputs(outputs, case, cfg, seed, csv)
    return csv.path
