"""Hybrid multi-TE super-resolution and 3-compartment tissue fit (superresHybrid).

Counterpart of ``mri_super_resolution_tpu/pipelines/hybrid.py``
(``HybridConfig`` :38, ``_hybrid_grid_model`` :74,
``mean_over_acquisitions`` :97, ``_fit_shared_grid`` :142, ``fit_all_te``
:206, ``remove_small_objects`` :324, ``make_pia_fitter`` :345,
``tissue_maps`` :378), the reference's superresHybrid.py:25-188. Per TE:
average the acquisitions of each b; max-normalise each (b, TE) volume; fit
an INR to the 4-b ROI volume on the ::2 LR grid; reconstruct at 2x and
assemble the (2sx, 2sy, S, 4 b, 4 TE) hybrid; normalise by the (b0, TE0)
channel x 1000; fit the 3-compartment model per voxel (D, T2, v maps);
polyfit ADC; cancer map (v_ep > 0.4) & (v_lu <= 0.2) without objects under
12 pixels.

``inr_model="siren"`` (the reference): four FF-SIRENs, one per TE, each with
its own Adam state; ``"grid"``: four :class:`GridINR` models, one per TE.
The JAX package vmaps the four fits into one program (``_make_fit_stack``
:109-137; on the TPU four K1s in one ``pallas_call``), and so does the port:
the four models are stacked, and each epoch is one batched step and one
:class:`~mri_super_resolution_tpu_torch.fit.optim.StackedAdam` step over
them (``fit_simple_batched``). The SIREN arm's step is one batched K1
(``siren_loss_grads_batched``; on a CUDA device one call of
``csrc/siren_wg.cu``'s batched kernel over the four TEs), its inference K3 (``siren_forward``)
per TE, and there is no autograd route on the card; the grid arm's step is
the tensor path over the stacked grids
(``models/grid_inr.py:make_tensor_value_and_grad_batched``), its inference
the tensor path per TE.
``"grid_shared"``: one GridINR over all 16 (b, TE) channels as a 16-slot
embedding (a change beyond the reference, which fits each TE alone). The
grid arms are plain PyTorch everywhere, and unpadded where the JAX package
pads the slice axis to a bucket (the same loss; ``models/grid_inr.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from mri_super_resolution_tpu_torch import resolve_device, set_float32_precision
from mri_super_resolution_tpu_torch.core.adc import adc_polyfit
from mri_super_resolution_tpu_torch.core.coords import (
    fourier_encode,
    fourier_matrix,
    mgrid,
)
from mri_super_resolution_tpu_torch.fit.engine import (
    fit_simple,
    fit_simple_batched,
    infer_dense_grid,
)
from mri_super_resolution_tpu_torch.fit.optim import StackedAdam, restart_adam
from mri_super_resolution_tpu_torch.models import PIA, GridINR, Siren
from mri_super_resolution_tpu_torch.models.grid_inr import (
    infer_tensor_grid,
    make_tensor_value_and_grad,
    make_tensor_value_and_grad_batched,
)
from mri_super_resolution_tpu_torch.ops.nlls import hybrid_fit
from mri_super_resolution_tpu_torch.ops.siren_kernel import make_fused_value_and_grad_batched
from mri_super_resolution_tpu_torch.pipelines import pia_train
from mri_super_resolution_tpu_torch.pipelines.superres3d import (
    _kernel_apply,
    _sync,
    normalize_hybrid,
)

EPS = 1e-7


@dataclasses.dataclass
class HybridConfig:
    number_of_epochs: int = 2500
    hidden_dim: int = 512
    num_layers: int = 3
    mapping_size: int = 128
    ff_scale: float = 0.5
    roi_start_x: int = 35
    roi_end_x: int = 95
    roi_start_y: int = 35
    roi_end_y: int = 95
    lr: float = 1e-4
    nlls_iters: int = 40
    # "siren" (the reference), "grid" (four GridINRs) or "grid_shared" (one
    # GridINR over the 16 (b, TE) channels)
    inr_model: str = "siren"
    # > 0: Adam with moment restarts every N steps on the INR fits
    inr_restart_every: int = 0
    grid_levels: int = 4
    grid_base_resolution: int = 6
    grid_features: int = 4
    grid_hidden: int = 64
    grid_lr: float = 5e-3
    grid_z_divisor: int = 1  # ROI-cropped grids: z comparable to in-plane


def _hybrid_grid_model(cfg: HybridConfig, num_b: int = 4,
                       gen: torch.Generator | None = None, dev=None) -> GridINR:
    return GridINR(num_levels=cfg.grid_levels, base_resolution=cfg.grid_base_resolution,
                   features_per_level=cfg.grid_features, hidden=cfg.grid_hidden,
                   z_divisor=cfg.grid_z_divisor, num_b=num_b, generator=gen, device=dev)


@dataclasses.dataclass
class HybridResult:
    recon_hybrid: np.ndarray  # (2sx, 2sy, S, 4, 4) de-normalised
    maxes: np.ndarray
    # phase wall-clock (seconds), device-synchronised at the prep/fit/infer
    # boundaries
    timings: dict = dataclasses.field(default_factory=dict)
    losses: np.ndarray | None = None  # (fits, epochs) loss traces


def mean_over_acquisitions(hybrid_raw_all_acq) -> list[list[np.ndarray]]:
    """Per (b, TE): the mean over the acquisition axis for b > 0
    (superresHybrid.py:52-56)."""
    out = [[None] * 4 for _ in range(4)]
    for b in range(4):
        for te in range(4):
            arr = np.asarray(hybrid_raw_all_acq[b][te], dtype=np.float32)
            out[b][te] = arr.mean(-1) if (b and arr.ndim == 4) else arr
    return out


def te_targets(normed, cfg: HybridConfig) -> tuple[tuple, np.ndarray]:
    """The per-TE fits' LR grid ``(sx', sy', S, 4)`` (the ROI at ::2, the
    four b values) and their (4, P, 1) float32 targets, from the
    max-normalised volumes of :func:`normalize_hybrid`."""
    lr_targets = []
    for te in range(4):
        vol = np.stack([normed[b][te] for b in range(4)], axis=-1)  # (X, Y, S, 4)
        lr = vol[cfg.roi_start_x:cfg.roi_end_x:2, cfg.roi_start_y:cfg.roi_end_y:2]
        lr_targets.append(lr.reshape(-1, 1))
    sx = cfg.roi_end_x - cfg.roi_start_x
    sy = cfg.roi_end_y - cfg.roi_start_y
    lr_shape = (sx // 2 + sx % 2, sy // 2 + sy % 2, normed[0][0].shape[2], 4)
    return lr_shape, np.stack(lr_targets).astype(np.float32)


def _timings(t0, t_prep, t_fit, t_infer, cfg: HybridConfig, lr_voxels: int,
             dev: torch.device) -> dict:
    return {"prep_s": t_prep - t0, "fit_s": t_fit - t_prep, "infer_s": t_infer - t_fit,
            "fit_epochs": cfg.number_of_epochs, "lr_voxels_per_te": lr_voxels,
            "inr_model": cfg.inr_model, "platform": dev.type}


def _fit(params, lr: float, cfg: HybridConfig, coords, target, vag) -> torch.Tensor:
    """One INR's ``number_of_epochs`` full-batch Adam steps; the loss trace."""
    opt = restart_adam(params, lr, cfg.inr_restart_every)
    return fit_simple(None, opt, coords, target, cfg.number_of_epochs,
                      value_and_grad_fn=vag).losses


def _fit_shared_grid(normed, maxes, cfg: HybridConfig, seed: int, t0: float,
                     dev: torch.device, init: dict | None) -> HybridResult:
    """One GridINR over the (x, y, z, 16) hybrid, the (b, TE) pair a 16-slot
    embedding in b-major order."""
    S = normed[0][0].shape[2]
    sx = cfg.roi_end_x - cfg.roi_start_x
    sy = cfg.roi_end_y - cfg.roi_start_y
    vol16 = np.stack([np.asarray(normed[b][te], dtype=np.float32)
                      for b in range(4) for te in range(4)], axis=-1)  # (X, Y, S, 16)
    lr = vol16[cfg.roi_start_x:cfg.roi_end_x:2, cfg.roi_start_y:cfg.roi_end_y:2]
    lr_shape = tuple(int(s) for s in lr.shape)
    target = torch.as_tensor(np.ascontiguousarray(lr.reshape(-1, 1)), device=dev)
    _sync(dev)
    t_prep = time.perf_counter()

    model = _hybrid_grid_model(cfg, 16, torch.Generator().manual_seed(int(seed)), dev)
    if init is not None:
        model.load_state_dict(init["inr"])
    model.requires_grad_(False)
    losses = _fit(model.params(), cfg.grid_lr, cfg, mgrid(lr_shape, device=dev), target,
                  make_tensor_value_and_grad(lr_shape))
    _sync(dev)
    t_fit = time.perf_counter()

    test_shape = (sx * 2, sy * 2, S, 16)
    rec = infer_tensor_grid(model.params(), test_shape, clamp_min=0.0)
    rec = rec.reshape(sx * 2, sy * 2, S, 4, 4)  # b-major slots -> (b, te)
    recon_hybrid = (rec * maxes[None, None, None]).astype(np.float32)
    t_infer = time.perf_counter()
    timings = _timings(t0, t_prep, t_fit, t_infer, cfg, target.shape[0] // 4, dev)
    return HybridResult(recon_hybrid, maxes, timings, losses[None].cpu().numpy())


def fit_all_te(hybrid_raw, cfg: HybridConfig, seed: int = 0,
               device: str | torch.device = "cuda", init: dict | None = None
               ) -> HybridResult:
    """Fit the four per-TE volumes and assemble the 2x hybrid.

    ``init`` optionally fixes the starting point: ``{"B": (m, 4) numpy
    Fourier matrix, "inr": four state_dicts, one per TE}`` (``"grid_shared"``:
    ``{"inr": one state_dict}``; ``convert.py`` makes them from the JAX
    package's params). Without it B and the initial weights are drawn from a
    generator seeded with ``seed``."""
    if cfg.inr_model not in ("siren", "grid", "grid_shared"):
        raise ValueError(f"unknown inr_model {cfg.inr_model!r}")
    dev = resolve_device(device)
    set_float32_precision()
    t0 = time.perf_counter()
    normed, maxes = normalize_hybrid(hybrid_raw)
    if cfg.inr_model == "grid_shared":
        return _fit_shared_grid(normed, maxes, cfg, seed, t0, dev, init)
    S = normed[0][0].shape[2]
    sx = cfg.roi_end_x - cfg.roi_start_x
    sy = cfg.roi_end_y - cfg.roi_start_y
    lr_shape, lr_targets = te_targets(normed, cfg)
    targets = torch.as_tensor(lr_targets, device=dev)
    _sync(dev)
    t_prep = time.perf_counter()

    gen = torch.Generator().manual_seed(int(seed))
    if init is not None:
        B = torch.as_tensor(np.array(init["B"], dtype=np.float32), device=dev)
    else:
        B = fourier_matrix(gen, cfg.mapping_size, 4, scale=cfg.ff_scale, device=dev)
    coords = mgrid(lr_shape, device=dev)
    if cfg.inr_model == "grid":
        models = [_hybrid_grid_model(cfg, 4, gen, dev) for _ in range(4)]
    else:
        models = [Siren(2 * cfg.mapping_size, cfg.hidden_dim, cfg.num_layers,
                        generator=gen, device=dev) for _ in range(4)]
    for te, model in enumerate(models):
        if init is not None:
            model.load_state_dict(init["inr"][te])
        model.requires_grad_(False)
    # the four TEs' models stacked: one batched step an epoch (the grid
    # arm's tensor path over stacked grids, the SIREN arm's batched K1)
    if cfg.inr_model == "grid":
        stacked = zip(*(m.params() for m in models))
        lr, x = cfg.grid_lr, coords
        vag = make_tensor_value_and_grad_batched(lr_shape)
    else:
        stacked = zip(*(m.weights() for m in models))
        lr, x = cfg.lr, fourier_encode(coords, B)
        vag = make_fused_value_and_grad_batched(models[0])
    opt = StackedAdam([torch.stack(ps) for ps in stacked], lr,
                      restart_every=max(int(cfg.inr_restart_every), 0))
    losses = fit_simple_batched(opt, x, targets, cfg.number_of_epochs, vag).losses.T
    params = [[p[te] for p in opt.params] for te in range(4)]
    _sync(dev)
    t_fit = time.perf_counter()

    test_shape = (sx * 2, sy * 2, S, 4)
    recon_hybrid = np.zeros((sx * 2, sy * 2, S, 4, 4), dtype=np.float32)
    for te in range(4):
        if cfg.inr_model == "grid":
            rec = infer_tensor_grid(params[te], test_shape, clamp_min=0.0)
        else:
            rec = infer_dense_grid(functools.partial(_kernel_apply, models[0].omegas),
                                   params[te], test_shape, clamp_min=0.0, fourier_B=B)
        rec = rec.reshape(test_shape)
        for b in range(4):
            recon_hybrid[:, :, :, b, te] = rec[:, :, :, b] * maxes[b, te]
    t_infer = time.perf_counter()
    timings = _timings(t0, t_prep, t_fit, t_infer, cfg, int(targets.shape[1]), dev)
    return HybridResult(recon_hybrid, maxes, timings, losses.cpu().numpy())


def remove_small_objects(mask: np.ndarray, min_size: int = 12) -> np.ndarray:
    """``skimage.morphology.remove_small_objects`` with 4-connectivity."""
    from scipy import ndimage

    labeled, n = ndimage.label(mask, structure=np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]]))
    if n == 0:
        return np.zeros_like(mask, dtype=bool)
    sizes = ndimage.sum_labels(np.ones_like(mask), labeled, index=np.arange(1, n + 1))
    return np.isin(labeled, np.nonzero(sizes >= min_size)[0] + 1)


@dataclasses.dataclass
class SliceMaps:
    D: np.ndarray  # (H, W, 3)
    T2: np.ndarray
    v: np.ndarray
    adc: np.ndarray  # (H, W)
    cancer: np.ndarray  # (H, W) bool


def make_pia_fitter(params_path: str | None = None, train_steps: int = 4000,
                    seed: int = 0, device: str | torch.device = "cuda"):
    """A trained PIA encoder as ``fitter(signals) -> (D, T2, v)``, the
    drop-in for :func:`hybrid_fit` in :func:`tissue_maps`: the state dict
    that ``torch.save`` wrote at ``params_path`` (the ``pia`` CLI's
    ``--out``), else ``train_steps`` steps of noise-range pretraining
    (sigma log-uniform in [0.01, 0.1]) on synthetic draws seeded with
    ``seed``, drawn on ``device`` (a copy from the host every step would
    wait for the device)."""
    dev = resolve_device(device)
    model = PIA(generator=torch.Generator().manual_seed(int(seed)), device=dev)
    if params_path:
        model.load_state_dict(torch.load(params_path, map_location=dev))
    else:
        pia_train.train_synthetic(model, torch.Generator(dev).manual_seed(int(seed)),
                                  steps=train_steps, noise_range=(0.01, 0.1))

    def fitter(signals):
        return pia_train.predict_maps(model, torch.as_tensor(signals, device=dev))

    return fitter


def tissue_maps(result: HybridResult, bvalues: np.ndarray, _slice: int = 9,
                nlls_iters: int = 40, fitter=None,
                device: str | torch.device = "cuda") -> SliceMaps:
    """One slice's 3-compartment maps, ADC and cancer map
    (superresHybrid.py:127-186): the NLLS :func:`hybrid_fit` on ``device``,
    or ``fitter(signals) -> (D, T2, v)`` in its place (such as
    :func:`make_pia_fitter`'s)."""
    dev = resolve_device(device)
    set_float32_precision()  # the LM's normal equations in true float32
    rh = result.recon_hybrid
    H, W = rh.shape[:2]
    # normalise by (b0, TE0) x 1000 (superresHybrid.py:130-133)
    norm = 1000.0 * rh / (rh[:, :, :, 0:1, 0:1] + EPS)
    signals = np.ascontiguousarray(norm[:, :, _slice].reshape(H * W, 16))
    if fitter is None:
        D, T2, v = hybrid_fit(torch.as_tensor(signals, device=dev), iters=nlls_iters)
    else:
        D, T2, v = fitter(signals)
    D, T2, v = (torch.as_tensor(t).cpu().numpy() for t in (D, T2, v))
    adc = adc_polyfit(bvalues, torch.as_tensor(rh[:, :, _slice, :, 0], device=dev)).cpu().numpy()
    v_ep = v[:, 0].reshape(H, W)
    v_lu = v[:, 2].reshape(H, W)
    cancer = remove_small_objects((v_ep > 0.4) & (v_lu <= 0.2), min_size=12)
    return SliceMaps(D.reshape(H, W, 3), T2.reshape(H, W, 3), v.reshape(H, W, 3), adc, cancer)
