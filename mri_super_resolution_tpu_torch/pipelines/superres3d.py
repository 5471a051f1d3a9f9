"""3-D volume INR + PerturbNet super-resolution (the superresDWI pipeline),
SIREN, WIRE and dense-grid paths.

Counterpart of ``mri_super_resolution_tpu/pipelines/superres3d.py``. Per
patient: per-(b, TE) max normalisation -> combination mean and the cross-b
combinations on the LR ROI -> Fourier-encode the LR grid -> fit the SIREN on
the LR mean, then alternate INR and PerturbNet epochs -> dense-grid
inference at 2x and on the HR grid -> masked-SSIM-vs-spline rows, ADC maps
and PNG panels.

``inr_model="siren"`` (the reference): on a CUDA device the INR steps run K1
(``siren_loss_grads``), the PerturbNet steps K2 (the backward of
``siren_fused``) and every forward K3 (``siren_forward``).

``inr_model="wire"``: the INR reads the raw 4-D coordinates (no Fourier
encoding; the PerturbNet output goes to it as it is), the mean steps run K4
(``wire_loss_grads``) and inference K5 (``wire_forward``). The PerturbNet
steps differentiate through the plain :func:`wire_apply` with autograd, as
the JAX package differentiates through ``Wire.apply`` (the fused Gabor
forward has no backward for the input). With ``wire_trainable`` the mean
steps take autograd over the same module, so that omega/sigma get their
gradients; K5 still serves inference, reading them from the params.

``inr_model="grid"`` (the ``quality`` and ``fast`` presets): the
multiresolution :class:`GridINR` on the raw coordinates. No kernel: the
mean steps take autograd through the separable tensor-product forward on
``mgrid`` (the JAX package's z-bucketed program, without the buckets), the
PerturbNet steps differentiate through the gather forward
(:func:`grid_inr_apply`), and inference is :func:`infer_tensor_grid`. The
engine's one ``fit_alternating_pn`` call runs both of the JAX package's
programs: ``epochs - pn_epochs`` mean steps (its ``fit_simple``), then the
PerturbNet tail from absolute epoch ``epochs - pn_epochs`` (its
``phase2_start``), one Adam throughout, so ``restart_adam``'s schedule
counts across both.

On the CPU the same calls run the kernels' plain PyTorch versions.
``cfg.use_pallas=False`` (the JAX package's XLA route) has no counterpart on
the card for SIREN and WIRE, and is refused there.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import Callable, Sequence

import numpy as np
import torch

from mri_super_resolution_tpu_torch import resolve_device, set_float32_precision
from mri_super_resolution_tpu_torch.config import SupperresDWIConfig
from mri_super_resolution_tpu_torch.core.adc import adc_polyfit
from mri_super_resolution_tpu_torch.core.coords import (
    fourier_encode,
    fourier_matrix,
    mgrid,
)
from mri_super_resolution_tpu_torch.core.interp import rescale
from mri_super_resolution_tpu_torch.core.metrics import masked_ssim_protocol
from mri_super_resolution_tpu_torch.core.normalize import max_normalize
from mri_super_resolution_tpu_torch.data import (
    SSIM_HEADER,
    MetricsCSV,
    combination_mean,
    expand_combinations,
    load_mat,
)
from mri_super_resolution_tpu_torch.fit.engine import (
    fit_alternating_pn,
    infer_dense_grid,
)
from mri_super_resolution_tpu_torch.fit.optim import Adam, restart_adam
from mri_super_resolution_tpu_torch.models import (
    GridINR,
    PerturbNet,
    Siren,
    Wire,
    perturbnet_apply,
    wire_apply,
)
from mri_super_resolution_tpu_torch.models.grid_inr import (
    grid_inr_apply,
    infer_tensor_grid,
    make_tensor_value_and_grad,
)
from mri_super_resolution_tpu_torch.ops.siren_kernel import (
    siren_fused,
    siren_loss_grads,
)
from mri_super_resolution_tpu_torch.ops.wire_kernel import (
    make_wire_fused_apply,
    make_wire_value_and_grad,
)


@dataclasses.dataclass
class SR3DResult:
    recon_2x: np.ndarray  # (2sx, 2sy, S, 4) super-resolved at 2x
    sr_hr_grid: np.ndarray  # (sx, sy, S, 4) INR sampled on the HR grid
    mean_img: np.ndarray  # (X, Y, S, 4) combination-mean volume
    maxes: np.ndarray  # (4, 4) per-(b, TE) normalisation maxes
    bvalues: np.ndarray
    ssim_rows: list[tuple]
    inr: Siren | Wire | GridINR  # fitted INR (its parameters are the fit's result)
    pn: PerturbNet
    B: np.ndarray
    losses: np.ndarray  # per-epoch loss trace
    # phase wall-clock (seconds), device-synchronised at each boundary:
    # prep / setup / fit / infer / eval + total
    timings: dict = dataclasses.field(default_factory=dict)


def load_hybrid(data_address: str):
    """Load master.mat's ``hybrid_raw`` 4x4 cell and ``b`` (superresDWI.py:40-48),
    validating the schema with messages that name the file and entry."""
    data = load_mat(data_address)
    for var in ("hybrid_raw", "b"):
        if var not in data:
            raise ValueError(
                f"{data_address}: missing variable {var!r} (master.mat needs "
                "'hybrid_raw' -- a 4x4 cell of per-(b, TE) acquisition stacks -- "
                f"and 'b', the b-value row); file contains {sorted(data)}")
    hybrid = data["hybrid_raw"]
    try:
        n_b, n_te = len(hybrid), len(hybrid[0])
    except (TypeError, IndexError) as e:
        raise ValueError(f"{data_address}: 'hybrid_raw' is not a cell array "
                         f"({type(hybrid).__name__}): {e}") from e
    if n_b != 4 or n_te != 4:
        raise ValueError(f"{data_address}: 'hybrid_raw' cell is {n_b}x{n_te}, "
                         "expected 4 b-values x 4 TEs")
    spatial = None
    for b in range(4):
        for te in range(4):
            arr = np.asarray(hybrid[b][te])
            if arr.ndim not in (3, 4):
                raise ValueError(
                    f"{data_address}: hybrid_raw[{b}][{te}] has shape {arr.shape}; "
                    "expected (X, Y, S) or (X, Y, S, n_acq)")
            if spatial is None:
                spatial = arr.shape[:3]
            elif arr.shape[:3] != spatial:
                raise ValueError(
                    f"{data_address}: hybrid_raw[{b}][{te}] spatial shape "
                    f"{arr.shape[:3]} != {spatial} of hybrid_raw[0][0]")
    bvals = np.asarray(data["b"], dtype=np.float64).reshape(-1)
    if bvals.size != 4:
        raise ValueError(f"{data_address}: 'b' has {bvals.size} entries, expected 4")
    return hybrid, bvals


def normalize_hybrid(hybrid_raw) -> tuple[list, np.ndarray]:
    """Per-(b, TE) max normalisation (superresDWI.py:50-55)."""
    maxes = np.zeros((4, 4))
    normed = [[None] * 4 for _ in range(4)]
    for b in range(4):
        for te in range(4):
            arr = np.asarray(hybrid_raw[b][te], dtype=np.float32)
            maxes[b, te] = arr.max()
            normed[b][te] = arr / maxes[b, te]
    return normed, maxes


def _kernel_apply(omegas, params, x):
    return siren_fused(x, params, omegas)


def _kernel_value_and_grad(omegas, params, x, target):
    return siren_loss_grads(x, params, target, omegas)


def _identity(x):
    """pn_encode of the raw-coordinate INR (WIRE): no Fourier re-mapping."""
    return x


def _grid_model(cfg: SupperresDWIConfig, gen: torch.Generator | None = None,
                dev=None) -> GridINR:
    """The pipeline's GridINR from its config (``_grid_model`` of the JAX
    package)."""
    return GridINR(num_levels=cfg.grid_levels, base_resolution=cfg.grid_base_resolution,
                   features_per_level=cfg.grid_features, hidden=cfg.grid_hidden,
                   z_divisor=cfg.grid_z_divisor, generator=gen, device=dev)


def _inr_model(cfg: SupperresDWIConfig, dim: int, gen: torch.Generator,
               dev: torch.device) -> Siren | Wire | GridINR:
    """The INR of ``cfg.inr_model``: WIRE and the grid read the raw
    ``dim``-D coordinates (the Gabor layer is its own frequency lift, the
    multiresolution grids are the encoding), SIREN their ``2 m``-wide
    Fourier encoding."""
    if cfg.inr_model == "grid":
        return _grid_model(cfg, gen, dev)
    if cfg.inr_model == "wire":
        return Wire(dim, cfg.wire_hidden, cfg.wire_layers,
                    omega_0=cfg.wire_omega, sigma_0=cfg.wire_sigma,
                    trainable=cfg.wire_trainable, generator=gen, device=dev)
    return Siren(in_features=2 * cfg.mapping_size, hidden_features=cfg.hidden_dim,
                 hidden_layers=cfg.num_layers, generator=gen, device=dev)


@dataclasses.dataclass(frozen=True)
class _Route:
    """How the pipeline fits and samples one INR."""
    params: list[torch.Tensor]
    apply: Callable  # differentiable in its input (the PerturbNet steps)
    value_and_grad: Callable | None  # the mean steps' (loss, grads); None: autograd
    infer: Callable  # (grid shape, clamp_min=None) -> host (P, out) array
    lr: float
    fourier_B: torch.Tensor | None  # encodes the INR's input; None: raw coordinates
    pn_encode: Callable | None  # PerturbNet output -> INR input; None: re-encode with B


def _route(cfg: SupperresDWIConfig, inr: Siren | Wire | GridINR, B: torch.Tensor,
           fit_shape: Sequence[int] | None = None) -> _Route:
    """``fit_shape``: the LR grid of the grid INR's tensor-path mean steps."""
    if isinstance(inr, GridINR):
        params = inr.params()
        return _Route(
            params=params, apply=grid_inr_apply,
            value_and_grad=None if fit_shape is None else make_tensor_value_and_grad(fit_shape),
            infer=functools.partial(infer_tensor_grid, params), lr=cfg.grid_lr,
            fourier_B=None, pn_encode=_identity)
    if isinstance(inr, Wire):
        nh = inr.hidden_layers
        params = inr.params()
        return _Route(
            params=params,
            apply=functools.partial(wire_apply, n_hidden=nh, trainable=inr.trainable),
            value_and_grad=None if inr.trainable else make_wire_value_and_grad(nh),
            infer=functools.partial(infer_dense_grid, make_wire_fused_apply(nh), params),
            lr=cfg.wire_lr, fourier_B=None, pn_encode=_identity)
    apply = functools.partial(_kernel_apply, inr.omegas)
    params = inr.weights()
    return _Route(
        params=params, apply=apply,
        value_and_grad=functools.partial(_kernel_value_and_grad, inr.omegas),
        infer=functools.partial(infer_dense_grid, apply, params, fourier_B=B),
        lr=cfg.inr_lr, fourier_B=B, pn_encode=None)


def _check_model(cfg: SupperresDWIConfig, device: str | torch.device) -> None:
    if cfg.inr_model not in ("siren", "wire", "grid"):
        raise ValueError(f"unknown inr_model {cfg.inr_model!r}")
    if (not cfg.use_pallas and cfg.inr_model != "grid"
            and torch.device(device).type == "cuda"):
        raise ValueError(
            "use_pallas=False: the port has no plain route on the card; its INR "
            "steps and inference always run the kernels there (K1-K3 for SIREN, "
            "K4-K5 for WIRE)")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ssim_table(hr_vol: np.ndarray, sr_vol: np.ndarray, device) -> tuple:
    """(SSIM spline, SSIM SR) per (slice, b) pair, index slice * 4 + b
    (superresDWI.py:179-187), as one batch."""
    X, Y = hr_vol.shape[:2]
    hrs = torch.as_tensor(hr_vol, device=device).permute(2, 3, 0, 1).reshape(-1, X, Y)
    srs = torch.as_tensor(sr_vol, device=device).permute(2, 3, 0, 1).reshape(-1, X, Y)
    hr_ref = max_normalize(hrs)
    # odd ROI sides: rescale(., 2) of the ::2 grid gives 2*ceil(n/2) rows
    up = rescale(hrs[:, ::2, ::2], 2, anti_aliasing=True)[:, :X, :Y]
    spline = max_normalize(up)
    sr_n = max_normalize(srs)
    return (masked_ssim_protocol(hr_ref, spline).cpu().numpy(),
            masked_ssim_protocol(hr_ref, sr_n).cpu().numpy())


def run_patient(
    hybrid_raw,
    bvalues: np.ndarray,
    cfg: SupperresDWIConfig,
    seed: int = 0,
    csv: MetricsCSV | None = None,
    pt_id: str | int = 0,
    device: str | torch.device = "cuda",
    init: dict | None = None,
) -> SR3DResult:
    """Fit one patient volume and compute the evaluation protocol.

    ``init`` optionally fixes the fit's starting point: ``{"B": (m, 4) numpy
    Fourier matrix, "inr": Siren, Wire or GridINR state_dict, "pn":
    PerturbNet state_dict}`` (``convert.py`` makes the last two from the JAX
    package's params). B is drawn for WIRE and the grid too, as the JAX
    pipeline draws it, and unused there.
    Without it, B and the initial weights are drawn from a generator seeded
    with ``seed``."""
    _check_model(cfg, device)
    dev = resolve_device(device)
    set_float32_precision()
    t0 = time.perf_counter()
    normed, maxes = normalize_hybrid(hybrid_raw)
    mean_img = combination_mean(normed, te=0).numpy()  # (X, Y, S, 4)

    r0, r1 = cfg.roi_start, cfg.roi_end
    lr_mean = mean_img[r0:r1:2, r0:r1:2]
    hr_mean = mean_img[r0:r1, r0:r1]
    lr_acqs = expand_combinations(*[
        torch.as_tensor(np.asarray(normed[b][0], dtype=np.float32)[r0:r1:2, r0:r1:2],
                        device=dev)
        for b in range(4)
    ])  # (sx/2, sy/2, S, 4, N), on the device
    num_comb = lr_acqs.shape[-1]
    dim = lr_mean.ndim

    gen = torch.Generator().manual_seed(int(seed))
    if init is not None:
        B = torch.as_tensor(np.array(init["B"], dtype=np.float32), device=dev)
    else:
        B = fourier_matrix(gen, cfg.mapping_size, dim, scale=cfg.ff_scale, device=dev)
    lr_coords = mgrid(lr_mean.shape, device=dev)
    mean_target = torch.as_tensor(np.ascontiguousarray(lr_mean.reshape(-1, 1)),
                                  device=dev)
    acq_pixels = lr_acqs.reshape(-1, num_comb).T.contiguous()[..., None]  # (N, P, 1)
    _sync(dev)
    t_prep = time.perf_counter()

    inr = _inr_model(cfg, dim, gen, dev)
    if init is not None:
        inr.load_state_dict(init["inr"])
    inr.requires_grad_(False)
    route = _route(cfg, inr, B, lr_mean.shape)
    ff = fourier_encode(lr_coords, route.fourier_B)  # the INR's input
    pn = PerturbNet(in_features=ff.shape[1], hidden_features=cfg.pn_dim,
                    dimension=dim, generator=gen, device=dev)
    if init is not None:
        pn.load_state_dict(init["pn"])
    pn.requires_grad_(False)
    inr_opt = restart_adam(route.params, route.lr, cfg.inr_restart_every)
    pn_opt = Adam(pn.weights(), cfg.pn_lr)
    t_setup = time.perf_counter()

    res = fit_alternating_pn(
        route.apply, perturbnet_apply, inr_opt, pn_opt, ff, mean_target, acq_pixels,
        B, num_epochs=cfg.number_of_epochs, pn_epochs=cfg.perturbation_epochs,
        pn_eps=cfg.pn_eps, inr_value_and_grad=route.value_and_grad,
        pn_encode=route.pn_encode,
    )
    _sync(dev)
    t_fit = time.perf_counter()

    hr_shape = hr_mean.shape
    test_shape = (hr_shape[0] * 2, hr_shape[1] * 2, hr_shape[2], hr_shape[3])
    recon = route.infer(test_shape, clamp_min=0.0).reshape(test_shape)
    sr_hr = route.infer(hr_shape, clamp_min=0.0).reshape(hr_shape)
    t_infer = time.perf_counter()

    ssim_sp, ssim_sr = _ssim_table(hr_mean, sr_hr, dev)
    ssim_rows = []
    for _slice in range(mean_img.shape[2]):
        for b in range(4):
            idx = _slice * 4 + b
            row = (pt_id, float(bvalues[b]), _slice, float(ssim_sp[idx]),
                   float(ssim_sr[idx]))
            ssim_rows.append(row)
            if csv is not None:
                csv.append(*row)
    t_eval = time.perf_counter()
    timings = {
        "prep_s": t_prep - t0,
        "setup_s": t_setup - t_prep,
        "fit_s": t_fit - t_setup,
        "infer_s": t_infer - t_fit,
        "eval_s": t_eval - t_infer,
        "total_s": t_eval - t0,
        "fit_epochs": cfg.number_of_epochs,
        "lr_voxels": int(mean_target.shape[0]),
        "num_combinations": int(num_comb),
        "inr_model": cfg.inr_model,
    }
    return SR3DResult(
        recon_2x=recon, sr_hr_grid=sr_hr, mean_img=mean_img, maxes=maxes,
        bvalues=bvalues, ssim_rows=ssim_rows, inr=inr, pn=pn,
        B=B.cpu().numpy(), losses=res.losses.cpu().numpy(), timings=timings,
    )


def adc_maps(result: SR3DResult, cfg: SupperresDWIConfig, _slice: int):
    """SR / spline / HR ADC triptych for one slice (superresDWI.py:189-212):
    each b-channel rescaled by ``maxes[b, te_index]`` before the polyfit."""
    r0, r1 = cfg.roi_start, cfg.roi_end
    scale_b = result.maxes[:, cfg.te_index]

    def up(img: np.ndarray, s: int) -> np.ndarray:
        return rescale(torch.as_tensor(img), s, anti_aliasing=True).numpy()

    recon_rescaled = result.recon_2x[:, :, _slice, :] * scale_b
    Hs, Ws = recon_rescaled.shape[:2]
    # odd ROI sides: rescale(., 4) of the ::2 grid overshoots by up to 2
    spline = np.stack([
        up(result.mean_img[r0:r1:2, r0:r1:2, _slice, b], 4)[:Hs, :Ws] * scale_b[b]
        for b in range(4)
    ], axis=-1)
    hr = np.stack([
        up(result.mean_img[r0:r1, r0:r1, _slice, b], 2) * scale_b[b]
        for b in range(4)
    ], axis=-1)
    bv = np.asarray(result.bvalues)
    return tuple(
        adc_polyfit(bv, torch.as_tensor(v, dtype=torch.float32)).numpy()
        for v in (recon_rescaled, spline, hr)
    )


def coronal_recon(result: SR3DResult, cfg: SupperresDWIConfig,
                  transverse_length: int = 100) -> np.ndarray:
    """Coronal dense-grid pass (superresDWI.py:217-241): the INR on a
    (2sx, 2sy, transverse_length, 1) grid (Fourier-encoded for SIREN, raw
    coordinates for WIRE, the tensor path for the grid)."""
    dev = next(result.inr.parameters()).device
    _check_model(cfg, dev)
    route = _route(cfg, result.inr, torch.as_tensor(result.B, device=dev))
    ts = result.recon_2x.shape
    coronal_shape = (ts[0], ts[1], transverse_length, 1)
    return route.infer(coronal_shape).reshape(coronal_shape)


def export_triplets(results: Sequence[SR3DResult], cfg: SupperresDWIConfig,
                    out_path: str, b_index: int = 3,
                    slice_range: tuple[int, int] = (10, 21)) -> str:
    """Zero-shot LR/GT/SR triplet export (forbagci.py:160-177): per patient and
    slice, the max-normalised HR reference, its ::2 LR and the SR
    reconstruction at b index ``b_index``, saved together in one npz."""
    r0, r1 = cfg.roi_start, cfg.roi_end
    lr_dataset, gt_dataset, zero_shot_sr = [], [], []
    for result in results:
        hr_img = result.mean_img[r0:r1, r0:r1]
        for _slice in range(*slice_range):
            if _slice >= hr_img.shape[2]:
                continue
            hr_ref = hr_img[:, :, _slice, b_index]
            hr_ref = hr_ref / (hr_ref.max() + 1e-12)
            sr = result.sr_hr_grid[:, :, _slice, b_index]
            sr = sr / (sr.max() + 1e-12)
            gt_dataset.append(hr_ref)
            lr_dataset.append(hr_ref[::2, ::2])
            zero_shot_sr.append(sr)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, lr_dataset=np.asarray(lr_dataset),
             gt_dataset=np.asarray(gt_dataset), zero_shot_SR=np.asarray(zero_shot_sr))
    return out_path


def export_artifact_of(result: SR3DResult, cfg: SupperresDWIConfig, out_dir: str,
                       pt_id: str | int = 0, device: str | torch.device = "cuda") -> dict:
    """The patient's fitted volume INR as a serving artifact (``serve.py``),
    its output the (b, te0)-normalised volume and the manifest holding the
    ``maxes`` that de-normalise it (physical = output * maxes[b][te]) and
    the b-values. The grid INR exports through ``export_grid_inr`` (three
    axis-coordinate vectors in, every axis length symbolic: one artifact
    serves the LR, HR and 2x grids); SIREN (its Fourier B baked in) and WIRE
    through ``export_inr`` on raw 4-D coordinates (x, y, z, b axis) in
    [-1, 1]. The artifact holds the plain module, not K3 or K5."""
    from mri_super_resolution_tpu_torch import serve

    extra = {"maxes": np.asarray(result.maxes).tolist(),
             "bvalues": np.asarray(result.bvalues).tolist()}
    note = "; output is the (b, te0)-normalized volume: de-normalize with manifest['maxes'][b][te]"
    if cfg.inr_model == "grid":
        desc = (f"sr3d pat{pt_id}: grid_inr L{cfg.grid_levels} R{cfg.grid_base_resolution}"
                f" h{cfg.grid_hidden}")
        return serve.export_grid_inr(result.inr, out_dir, device=device,
                                     model_desc=desc + note, extra_manifest=extra)
    if cfg.inr_model == "wire":
        B = None
        desc = (f"sr3d pat{pt_id}: wire {cfg.wire_hidden}x{cfg.wire_layers}"
                f" w{cfg.wire_omega} s{cfg.wire_sigma}")
    else:
        B = torch.as_tensor(result.B)
        desc = f"sr3d pat{pt_id}: siren {cfg.hidden_dim}x{cfg.num_layers} FF{cfg.mapping_size}"
    return serve.export_inr(result.inr, 4, out_dir, fourier_B=B, device=device,
                            model_desc=desc + note, extra_manifest=extra)


def run(
    patients: Sequence[tuple[str | int, object, np.ndarray]],
    cfg: SupperresDWIConfig,
    out_dir: str,
    seed: int = 0,
    save_panels: bool = False,
    export_npz: bool = False,
    export_artifact: bool = False,
    device: str | torch.device = "cuda",
    init: dict | None = None,
) -> str:
    """Driver over (pt_id, hybrid_raw, bvalues) tuples: writes
    ``pat<id>/ssim_scores.csv`` per patient and ``timings.json``; optionally
    PNG panels with ADC maps, the zero-shot triplet npz and, with
    ``export_artifact``, each patient's fitted INR as a serving artifact
    (``pat<id>/artifact/``, :func:`export_artifact_of`). ``init`` is passed
    to every :func:`run_patient`."""
    _check_model(cfg, device)
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for pt_id, hybrid_raw, bvalues in patients:
        pdir = os.path.join(out_dir, f"pat{pt_id}")
        os.makedirs(pdir, exist_ok=True)
        csv = MetricsCSV(os.path.join(pdir, "ssim_scores.csv"), SSIM_HEADER)
        result = run_patient(hybrid_raw, bvalues, cfg, seed=seed, csv=csv,
                             pt_id=pt_id, device=dev, init=init)
        results.append(result)
        if save_panels:
            _save_panels(result, cfg, pdir)
        if export_artifact:
            export_artifact_of(result, cfg, os.path.join(pdir, "artifact"), pt_id, dev)
    if export_npz:
        export_triplets(results, cfg, os.path.join(out_dir, "zero_shot_dwi.npz"))
    with open(os.path.join(out_dir, "timings.json"), "w") as f:
        json.dump(
            {
                "platform": dev.type,
                "device_name": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                "config": {
                    "epochs": cfg.number_of_epochs,
                    "pn_epochs": cfg.perturbation_epochs,
                    "hidden": cfg.hidden_dim,
                    "layers": cfg.num_layers,
                    "mapping_size": cfg.mapping_size,
                    "use_pallas": cfg.use_pallas,
                    "inr_model": cfg.inr_model,
                    "wire_hidden": cfg.wire_hidden,
                    "wire_layers": cfg.wire_layers,
                    "grid_levels": cfg.grid_levels,
                    "grid_hidden": cfg.grid_hidden,
                    "inr_restart_every": cfg.inr_restart_every,
                },
                "patients": [dict(r.timings, pt_id=str(p[0]))
                             for r, p in zip(results, patients)],
            },
            f,
            indent=1,
        )
    return out_dir


def _save_panels(result: SR3DResult, cfg: SupperresDWIConfig, out_dir: str) -> None:
    """PNG slice panels + ADC triptychs (superresDWI.py:164-212)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    r0, r1 = cfg.roi_start, cfg.roi_end
    for _slice in range(result.mean_img.shape[2]):
        fig, ax = plt.subplots(4, 3, figsize=(15, 20))
        for b in range(4):
            ax[b, 0].imshow(result.recon_2x[:, :, _slice, b], cmap="gray")
            ax[b, 0].set_title(f"super-resolution b={result.bvalues[b]}")
            spline = rescale(torch.as_tensor(result.mean_img[r0:r1:2, r0:r1:2, _slice, b]),
                             4, anti_aliasing=True).numpy()
            ax[b, 1].imshow(spline, cmap="gray")
            ax[b, 1].set_title("spline interpolation")
            hr = rescale(torch.as_tensor(result.mean_img[r0:r1, r0:r1, _slice, b]),
                         2, anti_aliasing=True).numpy()
            ax[b, 2].imshow(hr, cmap="gray")
            ax[b, 2].set_title("ground truth")
            for axi in range(3):
                ax[b, axi].axis("off")
        fig.savefig(
            os.path.join(out_dir,
                         f"slice_{_slice}_m_{cfg.mapping_size}_s_{cfg.ff_scale}.png"),
            bbox_inches="tight",
        )
        plt.close(fig)

        adc_sr, adc_sp, adc_hr = adc_maps(result, cfg, _slice)
        fig, ax = plt.subplots(1, 3, figsize=(12, 4))
        for a, (img, title) in enumerate([(adc_sr, "ADC of super-resolution"),
                                          (adc_sp, "ADC of spline"),
                                          (adc_hr, "ADC of HR")]):
            ax[a].imshow(img, vmin=0.3, vmax=3.0, cmap="gray")
            ax[a].set_title(title)
            ax[a].axis("off")
        fig.savefig(os.path.join(out_dir, f"ADC_slice_{_slice}.png"), bbox_inches="tight")
        plt.close(fig)
