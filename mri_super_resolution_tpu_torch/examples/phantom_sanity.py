"""Physical-phantom sanity checks: the kiwi / water-phantom protocol.

Counterpart of the JAX package's ``examples/phantom_sanity.py``. Reference:
superres-perturb.ipynb cell 9 fits the perturbed INR on kiwi-fruit phantom
scans; superres.ipynb cell 5 runs a water-phantom case. On objects whose
ground truth is known by construction (a uniform water disk; a kiwi's
radial wedges) the SR pipeline must not hallucinate structure (water) and
must keep real structure (kiwi).

The physical scans are not distributed, so both phantoms are synthesised
with the patient data's acquisition model (sub-pixel shifts between
acquisitions, Rician noise; ``data/synthetic.acquisitions_from_b0``) and
run through the half-res quality slice (``pipelines/lowres_qual.run_slice``:
phase 1 is one K1-a pass a step on a CUDA device). The gates:

1. WATER: the SR stays uniform inside the disk, its coefficient of
   variation within 2x of the acquisition mean's.
2. KIWI: the SR keeps the wedges, its masked SSIM against the clean
   phantom at least the spline baseline's less 0.05.

Run: ``python -m mri_super_resolution_tpu_torch.examples.phantom_sanity
[--device cuda] [--out_dir build/phantom_sanity]``; one JSON row a phantom,
then "phantom sanity OK". A PNG a phantom goes to ``--out_dir`` when
matplotlib is installed.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from mri_super_resolution_tpu_torch import resolve_device
from mri_super_resolution_tpu_torch.core.metrics import masked_ssim_protocol
from mri_super_resolution_tpu_torch.data.synthetic import acquisitions_from_b0
from mri_super_resolution_tpu_torch.pipelines import inr_erd, lowres_qual

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "build", "phantom_sanity")


def water_phantom(side: int = 64) -> np.ndarray:
    """A uniform disk on a zero background (air): the background keeps
    ``masked_ssim_protocol``'s hr > 0.05 mask on the object and the
    Rayleigh noise ROI free of signal."""
    y, x = (np.mgrid[0:side, 0:side] / side - 0.5) * 2
    r = np.sqrt(x**2 + y**2)
    return np.where(r < 0.75, 1.0, 0.0).astype(np.float32)


def kiwi_phantom(side: int = 64, wedges: int = 12) -> np.ndarray:
    """Radial wedge pattern, bright core and rind: a kiwi cross-section."""
    y, x = (np.mgrid[0:side, 0:side] / side - 0.5) * 2
    r = np.sqrt(x**2 + y**2)
    theta = np.arctan2(y, x)
    wedge = 0.5 + 0.35 * np.cos(wedges * theta) * np.clip((r - 0.12) / 0.6, 0, 1)
    img = np.where(r < 0.72, wedge, 0.0)  # zero background: see water_phantom
    img = np.where(r < 0.12, 0.95, img)  # core
    img = np.where((r >= 0.72) & (r < 0.8), 0.35, img)  # rind
    return img.astype(np.float32)


def acquisitions(img: np.ndarray, num_acq: int = 9, seed: int = 0) -> np.ndarray:
    """The patient data's acquisition model at b = 0 (no diffusion decay)
    without outliers: (H, W, num_acq)."""
    return acquisitions_from_b0(
        img[:, :, None], num_acq, b=0.0, seed=seed,
        noise_sigma_frac=0.02, shift_sigma=0.5, outlier_prob=0.0,
    )[:, :, 0, :]


def _save_png(name: str, res, clean: np.ndarray, out_dir: str) -> None:
    try:
        import matplotlib
    except ImportError:  # optional, as in the JAX package's example
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1, 4, figsize=(16, 4))
    for a, (im, title) in enumerate(
            [(res.lr, "LR"), (res.spline, "spline"), (res.sr, "SR"), (clean, "clean phantom")]):
        ax[a].imshow(im, cmap="gray")
        ax[a].set_title(f"{name}: {title}")
        ax[a].axis("off")
    os.makedirs(out_dir, exist_ok=True)
    fig.savefig(os.path.join(out_dir, f"{name}.png"), bbox_inches="tight")
    plt.close(fig)


def run_phantom(name: str, img: np.ndarray, out_dir: str = DEFAULT_OUT,
                cfg: lowres_qual.LowresQualConfig | None = None,
                device: str | torch.device = "cuda") -> dict:
    """One phantom through ``lowres_qual.run_slice``: its JSON row. ``cfg``
    defaults to the example's settings: the pipeline's with threshold 2e-4,
    50 phase-2 steps and at most 30,000 phase-1 steps."""
    if cfg is None:
        cfg = lowres_qual.LowresQualConfig(loss_threshold=2e-4, phase2_steps=50,
                                           max_pretrain_steps=30_000)
    acq = acquisitions(img)
    H, W = img.shape
    case = inr_erd.ERDCase(
        pt_id=f"phantom-{name}",
        b=(0.0, 150.0, 1000.0, 1500.0),
        cancer_loc=(H // 2, W // 2),
        contralateral_loc=(H // 4, W // 4),
        noise=(4, 4),
        cancer_slice=0,
        b0=(img + 0.1)[:, :, None],
        b3=acq[:, :, None, :],
    )
    res = lowres_qual.run_slice(case, 0, cfg, seed=0, device=device)

    clean = img / (img.max() + 1e-12)
    clean_t = torch.as_tensor(clean)
    ssim_sr_clean = float(masked_ssim_protocol(clean_t, torch.as_tensor(res.sr)))
    ssim_sp_clean = float(masked_ssim_protocol(clean_t, torch.as_tensor(res.spline)))

    mask = clean > 0.5

    def cv(a: np.ndarray) -> float:
        return float(np.std(a[mask]) / (np.mean(a[mask]) + 1e-12))

    row = {
        "phantom": name,
        "ssim_sr_vs_clean": round(ssim_sr_clean, 4),
        "ssim_spline_vs_clean": round(ssim_sp_clean, 4),
        "cv_acq_mean": round(cv(res.gt), 4),
        "cv_sr": round(cv(res.sr), 4),
    }
    _save_png(name, res, clean, out_dir)
    return row


def check_gates(water: dict, kiwi: dict) -> None:
    """The phantoms' gates; raises ``AssertionError`` naming the one that
    failed."""
    if not water["cv_sr"] < 2.0 * max(water["cv_acq_mean"], 0.01):
        raise AssertionError("water phantom: SR hallucinated structure")
    if not kiwi["ssim_sr_vs_clean"] >= kiwi["ssim_spline_vs_clean"] - 0.05:
        raise AssertionError("kiwi phantom: SR lost structure vs spline")


def main(argv=None, cfg: lowres_qual.LowresQualConfig | None = None,
         side: int = 64) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="where the fits run (default cuda; raises when no card is present)")
    p.add_argument("--out_dir", default=DEFAULT_OUT, help="where the PNGs go")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    rows = [
        run_phantom("water", water_phantom(side), args.out_dir, cfg, dev),
        run_phantom("kiwi", kiwi_phantom(side), args.out_dir, cfg, dev),
    ]
    for row in rows:
        print(json.dumps(row))
    check_gates(*rows)
    print("phantom sanity OK")
    return rows


if __name__ == "__main__":
    main()
