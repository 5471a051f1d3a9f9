"""3-D volume FF-SIREN + PerturbNet super-resolution on PyTorch (the
superresDWI pipeline).

Run as ``python -m mri_super_resolution_tpu_torch.cli.superres_dwi``. Same
flags as the JAX package's ``cli/superres_dwi.py`` plus ``--device``
(default ``cuda``; raises when no card is present). Loads master.mat files
when given, else synthesizes hybrid acquisitions from the mean-b0 volumes
under ``$MRI_SR_DATA_DIR`` (default ``anon_data``). Runs ``--inr_model
siren`` (the reference), ``--inr_model wire`` (the complex-Gabor INR on
the raw coordinates, ``--wire_*`` flags) and ``--inr_model grid`` (the
multiresolution dense-grid INR, ``--grid_*`` flags; ``--preset quality`` and
``--preset fast``). ``--export_artifact`` writes each patient's fitted INR
as a ``torch.export`` serving artifact under ``<out>/pat<id>/artifact``
(``serve.py``; the plain module, as the JAX package's artifact holds plain
XLA).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from mri_super_resolution_tpu_torch.config import SupperresDWIConfig, add_preset_arg
from mri_super_resolution_tpu_torch.data import (
    available_patients,
    default_data_dir,
    load_mat,
    synthetic,
)
from mri_super_resolution_tpu_torch.pipelines import superres3d


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--master_mats", nargs="*", default=None,
                   help="paths to master.mat files (else synthesize from anon_data)")
    p.add_argument("--epochs", type=int, default=2500)
    p.add_argument("--pn_epochs", type=int, default=10)
    p.add_argument("--hidden_dim", type=int, default=512)
    p.add_argument("--num_layers", type=int, default=3)
    p.add_argument("--mapping_size", type=int, default=128)
    p.add_argument("--roi_start", type=int, default=40)
    p.add_argument("--roi_end", type=int, default=90)
    p.add_argument("--limit_patients", type=int, default=None)
    p.add_argument("--save_panels", action="store_true")
    p.add_argument("--export_npz", action="store_true",
                   help="export zero-shot LR/GT/SR triplets (forbagci.py variant)")
    p.add_argument("--export_artifact", action="store_true",
                   help="export each patient's fitted INR as a serving artifact")
    p.add_argument("--synthetic_model", choices=("mono", "tissue"), default="mono",
                   help="synthetic hybrid physics when master.mat is absent")
    p.add_argument("--inr_lr", type=float, default=1e-4)
    p.add_argument("--inr_restart_every", type=int, default=0,
                   help="Adam moment restarts every N INR steps (0 = flat Adam)")
    p.add_argument("--inr_model", choices=("siren", "grid", "wire"), default="siren",
                   help="volume INR family: 'siren' (reference FF-SIREN), 'wire' "
                   "(complex Gabor on raw coordinates), 'grid' (multiresolution "
                   "dense grids)")
    p.add_argument("--wire_hidden", type=int, default=256)
    p.add_argument("--wire_layers", type=int, default=2)
    p.add_argument("--wire_lr", type=float, default=1e-3)
    p.add_argument("--wire_omega", type=float, default=10.0)
    p.add_argument("--wire_sigma", type=float, default=10.0)
    p.add_argument("--wire_trainable", action="store_true")
    p.add_argument("--grid_lr", type=float, default=5e-3)
    p.add_argument("--grid_levels", type=int, default=4)
    p.add_argument("--grid_base_resolution", type=int, default=6)
    p.add_argument("--grid_hidden", type=int, default=64)
    p.add_argument("--grid_features", type=int, default=4)
    p.add_argument("--grid_z_divisor", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="SR_results")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    add_preset_arg(p, argv)
    args = p.parse_args(argv)

    cfg = SupperresDWIConfig(
        number_of_epochs=args.epochs,
        perturbation_epochs=args.pn_epochs,
        hidden_dim=args.hidden_dim,
        num_layers=args.num_layers,
        mapping_size=args.mapping_size,
        roi_start=args.roi_start,
        roi_end=args.roi_end,
        inr_lr=args.inr_lr,
        inr_restart_every=args.inr_restart_every,
        inr_model=args.inr_model,
        grid_lr=args.grid_lr,
        grid_levels=args.grid_levels,
        grid_base_resolution=args.grid_base_resolution,
        grid_hidden=args.grid_hidden,
        grid_features=args.grid_features,
        grid_z_divisor=args.grid_z_divisor,
        wire_hidden=args.wire_hidden,
        wire_layers=args.wire_layers,
        wire_lr=args.wire_lr,
        wire_omega=args.wire_omega,
        wire_sigma=args.wire_sigma,
        wire_trainable=args.wire_trainable,
    )

    patients = []
    if args.master_mats:
        for path in args.master_mats:
            pt_id = os.path.basename(os.path.dirname(path)) or os.path.basename(path)
            hybrid, b = superres3d.load_hybrid(path)
            patients.append((pt_id, hybrid, b))
    else:
        data_dir = default_data_dir()
        b_values = (0.0, 150.0, 1000.0, 1500.0)
        rows = available_patients(data_dir)[: args.limit_patients]
        for pt_no in (row["pt_id"].split("-")[-1] for row in rows):
            b0 = np.asarray(
                load_mat(os.path.join(data_dir, f"pat{pt_no}_mean_b0.mat"),
                         "data_mean_b0"),
                dtype=np.float32,
            )
            if args.synthetic_model == "tissue":
                hybrid, _ = synthetic.hybrid_from_tissue(b0, b_values=b_values,
                                                         seed=int(pt_no))
            else:
                hybrid = synthetic.hybrid_from_b0(b0, b_values=b_values,
                                                  seed=int(pt_no))
            patients.append((pt_no, hybrid, np.asarray(b_values)))

    if not patients:
        p.error("no patients found")
    out = superres3d.run(
        patients, cfg, args.out, seed=args.seed, save_panels=args.save_panels,
        export_npz=args.export_npz, export_artifact=args.export_artifact,
        device=args.device,
    )
    print(f"results in {out}")


if __name__ == "__main__":
    main()
