"""Hybrid multi-TE super-resolution and 3-compartment tissue maps on PyTorch
(the superresHybrid pipeline).

Run as ``python -m mri_super_resolution_tpu_torch.cli.superres_hybrid``.
Same flags and presets as the JAX package's ``cli/superres_hybrid.py``,
plus ``--device`` (default ``cuda``; raises when no card is present) and
``--save_png`` (the map panels need matplotlib, so they are opt-in). Per
patient: the four per-TE INR fits (``--inr_model siren``, the reference,
runs K1 on every step and K3 for inference on the card), the 2x hybrid, and
for each slice the NLLS or PIA tissue fit, the ADC and the cancer map,
saved as ``pat<id>/maps_slice_<s>.npz``; ``timings.json`` holds each
patient's phases. Loads master.mat files when given, else synthesizes
hybrid acquisitions from the mean-b0 volumes under ``$MRI_SR_DATA_DIR``
(default ``anon_data``).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from mri_super_resolution_tpu_torch.config import add_preset_arg
from mri_super_resolution_tpu_torch.data import (
    available_patients,
    default_data_dir,
    load_mat,
    synthetic,
)
from mri_super_resolution_tpu_torch.pipelines import superres3d
from mri_super_resolution_tpu_torch.pipelines.hybrid import (
    HybridConfig,
    fit_all_te,
    make_pia_fitter,
    mean_over_acquisitions,
    tissue_maps,
)


def _save_maps_png(maps, out_dir: str, _slice: int) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = ["D_ep", "D_st", "D_lu", "v_ep", "v_st", "v_lu", "ADC", "cancer"]
    imgs = [maps.D[:, :, 0], maps.D[:, :, 1], maps.D[:, :, 2],
            maps.v[:, :, 0], maps.v[:, :, 1], maps.v[:, :, 2],
            maps.adc, maps.cancer.astype(float)]
    fig, axes = plt.subplots(2, 4, figsize=(14, 7))
    for ax, name, img in zip(axes.ravel(), names, imgs):
        im = ax.imshow(img, cmap="turbo" if name != "cancer" else "gray")
        ax.set_title(name)
        ax.axis("off")
        fig.colorbar(im, ax=ax, fraction=0.046)
    fig.suptitle(f"slice {_slice}")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, f"maps_slice_{_slice}.png"), dpi=110)
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--master_mats", nargs="*", default=None,
                   help="paths to master.mat files (else synthesize from anon_data)")
    p.add_argument("--epochs", type=int, default=2500)
    p.add_argument("--hidden_dim", type=int, default=512)
    p.add_argument("--num_layers", type=int, default=3)
    p.add_argument("--mapping_size", type=int, default=128)
    p.add_argument("--limit_patients", type=int, default=1)
    p.add_argument("--slices", type=int, nargs="*", default=None,
                   help="slice indices for tissue maps (default: middle slice)")
    p.add_argument("--nlls_iters", type=int, default=40)
    p.add_argument("--roi_start", type=int, default=35,
                   help="ROI start on both in-plane axes (superresHybrid.py crops 35:95)")
    p.add_argument("--roi_end", type=int, default=95)
    p.add_argument("--inr_model", choices=("siren", "grid", "grid_shared"),
                   default="siren",
                   help="per-TE INR: the reference's FF-SIREN, the multiresolution "
                   "dense-grid model (tensor-product fit path), or grid_shared: one "
                   "grid over all 4 TEs through a 16-slot (b, TE) embedding")
    p.add_argument("--inr_restart_every", type=int, default=0,
                   help=">0: Adam moment restarts on the INR fits every N steps")
    p.add_argument("--grid_z_divisor", type=int, default=1)
    p.add_argument("--grid_lr", type=float, default=5e-3)
    p.add_argument("--tissue_fit", choices=("nlls", "pia"), default="nlls",
                   help="3-compartment fitter for the tissue maps: the projected-LM "
                   "NLLS (the reference's) or the amortized PIA encoder")
    p.add_argument("--pia_ckpt", default=None,
                   help="PIA state dict for --tissue_fit pia (the pia CLI's --out); "
                   "else a fresh noise-range pretrain runs first")
    p.add_argument("--pia_train_steps", type=int, default=4000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="hybrid_results")
    p.add_argument("--save_png", action="store_true",
                   help="also save each slice's map panel as PNG (needs matplotlib)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    add_preset_arg(p, argv)
    args = p.parse_args(argv)

    cfg = HybridConfig(
        number_of_epochs=args.epochs, hidden_dim=args.hidden_dim,
        num_layers=args.num_layers, mapping_size=args.mapping_size,
        nlls_iters=args.nlls_iters,
        roi_start_x=args.roi_start, roi_end_x=args.roi_end,
        roi_start_y=args.roi_start, roi_end_y=args.roi_end,
        inr_model=args.inr_model, inr_restart_every=args.inr_restart_every,
        grid_z_divisor=args.grid_z_divisor, grid_lr=args.grid_lr,
    )

    patients = []
    if args.master_mats:
        for path in args.master_mats:
            pt_id = (os.path.basename(os.path.dirname(path))
                     or os.path.splitext(os.path.basename(path))[0])
            hybrid_all, b = superres3d.load_hybrid(path)
            patients.append((pt_id, hybrid_all, np.asarray(b)))
    else:
        data_dir = default_data_dir()
        b_values = (0.0, 150.0, 1000.0, 1500.0)
        for row in available_patients(data_dir)[: args.limit_patients]:
            pt_no = row["pt_id"].split("-")[-1]
            b0 = np.asarray(load_mat(os.path.join(data_dir, f"pat{pt_no}_mean_b0.mat"),
                                     "data_mean_b0"), dtype=np.float32)
            hybrid_all = synthetic.hybrid_from_b0(b0, b_values=b_values, seed=int(pt_no))
            patients.append((pt_no, hybrid_all, np.asarray(b_values)))
    if not patients:
        p.error("no patients found")

    fitter = None
    if args.tissue_fit == "pia":
        fitter = make_pia_fitter(params_path=args.pia_ckpt,
                                 train_steps=args.pia_train_steps, seed=args.seed,
                                 device=args.device)

    all_timings = []
    for pt_id, hybrid_all, bvalues in patients:
        out_dir = os.path.join(args.out, f"pat{pt_id}")
        os.makedirs(out_dir, exist_ok=True)
        hybrid = mean_over_acquisitions(hybrid_all)
        result = fit_all_te(hybrid, cfg, seed=args.seed, device=args.device)
        S = result.recon_hybrid.shape[2]
        slices = args.slices if args.slices else [S // 2]
        t_tissue = 0.0
        for _slice in slices:
            t0 = time.perf_counter()
            maps = tissue_maps(result, bvalues, _slice=_slice, nlls_iters=cfg.nlls_iters,
                               fitter=fitter, device=args.device)
            t_tissue += time.perf_counter() - t0  # the maps are host arrays
            np.savez_compressed(os.path.join(out_dir, f"maps_slice_{_slice}.npz"),
                                D=maps.D, T2=maps.T2, v=maps.v, adc=maps.adc,
                                cancer=maps.cancer)
            if args.save_png:
                _save_maps_png(maps, out_dir, _slice)
            print(f"pat{pt_id} slice {_slice}: cancer-map fraction "
                  f"{float(maps.cancer.mean()):.4f}")
        row = dict(result.timings, pt_id=str(pt_id), tissue_fit=args.tissue_fit,
                   n_slices=len(slices), tissue_s_per_slice=t_tissue / max(len(slices), 1))
        row["total_s"] = row["prep_s"] + row["fit_s"] + row["infer_s"] + t_tissue
        all_timings.append(row)
        print(f"pat{pt_id}: maps in {out_dir}; fit {row['fit_s']:.1f}s infer "
              f"{row['infer_s']:.1f}s tissue {t_tissue:.1f}s")
    with open(os.path.join(args.out, "timings.json"), "w") as f:
        json.dump({"config": {"epochs": cfg.number_of_epochs, "inr_model": cfg.inr_model,
                              "inr_restart_every": cfg.inr_restart_every,
                              "tissue_fit": args.tissue_fit},
                   "patients": all_timings}, f, indent=1)


if __name__ == "__main__":
    main()
