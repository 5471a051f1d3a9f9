"""End-to-end 3-D super-resolution walkthrough: the SR3D.ipynb /
super-res_example.ipynb capability as a runnable script.

Counterpart of the JAX package's ``examples/sr3d_demo.py``. Synthesises
hybrid acquisitions from a mean-b0 volume (``pat07_mean_b0.mat`` under
``$MRI_SR_DATA_DIR``, default ``anon_data``; a random volume when it is
missing), runs ``pipelines/superres3d.run_patient`` at a reduced
configuration (a SIREN of width 256 x 2 on a mapping of 64: K1-K3 on a
CUDA device) and prints the SSIM table, SR against the spline baseline
(the per-run self-check the reference builds into every experiment).

Run: ``python -m mri_super_resolution_tpu_torch.examples.sr3d_demo
[--epochs 300] [--pn_epochs 6] [--seed 0] [--device cuda]``
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from mri_super_resolution_tpu_torch.config import SupperresDWIConfig
from mri_super_resolution_tpu_torch.data import default_data_dir, load_mat, synthetic
from mri_super_resolution_tpu_torch.pipelines import superres3d


def load_b0() -> np.ndarray:
    """Slices 8-15 of pat07's mean b0, else a random (128, 128, 8) volume."""
    b0_path = os.path.join(default_data_dir(), "pat07_mean_b0.mat")
    if os.path.exists(b0_path):
        return np.asarray(load_mat(b0_path, "data_mean_b0"), dtype=np.float32)[:, :, 8:16]
    rng = np.random.default_rng(0)
    return np.abs(rng.normal(1.0, 0.3, (128, 128, 8))).astype(np.float32)


def main(argv=None, b0: np.ndarray | None = None, **cfg_overrides):
    """``b0`` and ``cfg_overrides`` (``SupperresDWIConfig`` fields) let a
    caller run it small; returns the pipeline's result."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--pn_epochs", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the fit runs (default cuda; raises when no card is present)")
    args = p.parse_args(argv)

    b0 = load_b0() if b0 is None else b0
    bvalues = np.asarray([0.0, 150.0, 1000.0, 1500.0])
    hybrid = synthetic.hybrid_from_b0(b0, b_values=bvalues, acq_counts=(1, 2, 3, 3), seed=7)

    cfg = SupperresDWIConfig(**{
        "number_of_epochs": args.epochs,
        "perturbation_epochs": args.pn_epochs,
        "hidden_dim": 256,
        "num_layers": 2,
        "mapping_size": 64,
        **cfg_overrides,
    })
    result = superres3d.run_patient(hybrid, bvalues, cfg, seed=args.seed, pt_id="demo",
                                    device=args.device)

    print("\nslice  b-value  SSIM(spline)  SSIM(SR)")
    wins = 0
    for pt, b, s, ssim_sp, ssim_sr in result.ssim_rows:
        print(f"{s:5d}  {b:7.0f}  {ssim_sp:12.4f}  {ssim_sr:8.4f}")
        wins += ssim_sr > ssim_sp
    n = len(result.ssim_rows)
    print(f"\nSR beats spline interpolation on {wins}/{n} slice x b combinations")
    return result


if __name__ == "__main__":
    main()
