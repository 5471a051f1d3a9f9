"""Soft-ERD two-phase INR fine-tune (INR_ERD.py) on PyTorch.

Run as ``python -m mri_super_resolution_tpu_torch.cli.inr_erd``. The flags
of the JAX package's ``cli/inr_erd.py`` and ``--device`` (default ``cuda``;
raises when no card is present). A case reads the real
``<data_dir>/<pt_no>/no_aver/bigImage.mat`` (INR_ERD.py:89-95) when it is
there; otherwise its high-b acquisitions are synthesised from
``pat<NN>_mean_b0.mat`` with the patient number as seed. Either way the
case is divided by its b0 maximum: the 2e-5 loss threshold assumes
unit-order volumes. Checkpoints go to ``--models_dir`` as ``.pt`` state
dicts.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from mri_super_resolution_tpu_torch.config import INRERDConfig
from mri_super_resolution_tpu_torch.data import (
    available_patients,
    default_data_dir,
    load_mat,
    synthetic,
)
from mri_super_resolution_tpu_torch.pipelines import inr_erd


def _load_bigimage(path):
    """A real bigImage.mat: b0 (H, W, S) and b3 (H, W, S, A), its schema
    checked with precise errors."""
    data = load_mat(path)
    missing = [k for k in ("b0", "b1", "b2", "b3") if k not in data]
    if missing:
        raise ValueError(
            f"{path}: missing variable(s) {missing} (bigImage.mat holds "
            f"'b0'..'b3' per INR_ERD.py:92-95); file contains {sorted(data)}")
    b0 = np.asarray(data["b0"], dtype=np.float32)
    b3 = np.asarray(data["b3"], dtype=np.float32)
    if b0.ndim != 3:
        raise ValueError(f"{path}: 'b0' has shape {b0.shape}, expected (H, W, S)")
    if b3.ndim != 4 or b3.shape[:3] != b0.shape:
        raise ValueError(f"{path}: 'b3' has shape {b3.shape}, expected "
                         f"{b0.shape} + (n_acq,)")
    return b0, b3


def build_cases(limit=None, num_acq=9, data_dir=None, acq_kwargs=None):
    """ERD cases of every available patient, at most ``limit``;
    ``acq_kwargs`` goes to the synthetic acquisition generator."""
    data_dir = data_dir or default_data_dir()
    cases = []
    for row in available_patients(data_dir)[:limit]:
        pt_no = row["pt_id"].split("-")[-1]
        b = (0.0, 150.0, 1000.0, 1500.0) if row["b"] == 1500.0 else (0.0, 300.0, 600.0, 900.0)
        bigimage = os.path.join(data_dir, pt_no, "no_aver", "bigImage.mat")
        if os.path.exists(bigimage):
            b0, b3 = _load_bigimage(bigimage)
            scale = float(b0.max()) + 1e-12
            b0, b3 = b0 / scale, b3 / scale
        else:
            b0 = np.asarray(load_mat(os.path.join(data_dir, f"pat{pt_no}_mean_b0.mat"),
                                     "data_mean_b0"), dtype=np.float32)
            b0 = b0 / (float(b0.max()) + 1e-12)
            b3 = synthetic.acquisitions_from_b0(b0, num_acq=num_acq, b=b[3], seed=int(pt_no),
                                                **(acq_kwargs or {}))
        cases.append(inr_erd.ERDCase(
            pt_id=row["pt_id"], b=b, cancer_loc=row["cancer_loc"],
            contralateral_loc=row["contralateral_loc"], noise=row["noise"],
            cancer_slice=row["cancer_slice"], b0=b0, b3=b3))
    return cases


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, default=10)
    p.add_argument("--limit_cases", type=int, default=None)
    p.add_argument("--num_acq", type=int, default=9)
    p.add_argument("--loss_threshold", type=float, default=2e-5)
    p.add_argument("--hidden_features", type=int, default=128)
    p.add_argument("--hidden_layers", type=int, default=3)
    p.add_argument("--out_csv", default="experiments.csv")
    p.add_argument("--models_dir", default="models")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    cfg = INRERDConfig(seeds=args.seeds, loss_threshold=args.loss_threshold,
                       hidden_features=args.hidden_features,
                       hidden_layers=args.hidden_layers)
    cases = build_cases(args.limit_cases, args.num_acq, args.data_dir)
    if not cases:
        p.error("no cases found")
    os.makedirs(args.models_dir, exist_ok=True)
    path = inr_erd.run(cases, cfg, args.out_csv, models_dir=os.path.abspath(args.models_dir),
                       device=args.device)
    print(f"metrics written to {path}")
    return path


if __name__ == "__main__":
    main()
