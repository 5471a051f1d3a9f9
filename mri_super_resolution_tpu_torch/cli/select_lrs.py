"""LR slice panels for picking acquisitions by eye (selectLRs.py).

Run as ``python -m mri_super_resolution_tpu_torch.cli.select_lrs``. Loads
each patient's hybrid volume (``--master_mats``, else synthesised from the
data directory's mean b0 with the patient number as seed), max-normalises
each (b, TE) volume, forms the TE0 mean image per b-value, and writes a
3-wide PNG panel of the ROI's ::2 LR view for every (slice >=
``--first_slice``, b) pair, titled with the b-value. The flags of the JAX
package's ``cli/select_lrs.py``. It runs on the CPU only: it does no tensor
work, and needs matplotlib (imported in ``main``).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from mri_super_resolution_tpu_torch.data import (
    available_patients,
    default_data_dir,
    load_mat,
    synthetic,
)
from mri_super_resolution_tpu_torch.pipelines.superres3d import load_hybrid, normalize_hybrid


def mean_images(hybrid_raw, b_values) -> np.ndarray:
    """Normalised TE0 mean image per b (selectLRs.py:37-47): b=0 is a single
    volume; b>0 averages the acquisition axis."""
    normed, _ = normalize_hybrid(hybrid_raw)
    shape = np.asarray(normed[0][0]).shape[:3]
    mean_img = np.zeros(shape + (len(b_values),), np.float32)
    for b in range(len(b_values)):
        vol = np.asarray(normed[b][0])
        mean_img[..., b] = vol if vol.ndim == 3 else vol.mean(-1)
    return mean_img


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--master_mats", nargs="*", default=None,
                   help="paths to master.mat files (else synthesised from the data "
                        "directory's mean b0)")
    p.add_argument("--roi_start", type=int, default=40)
    p.add_argument("--roi_end", type=int, default=90)
    p.add_argument("--first_slice", type=int, default=4,
                   help="first slice to panel (selectLRs.py:51 starts at 4)")
    p.add_argument("--limit_patients", type=int, default=None)
    p.add_argument("--limit_slices", type=int, default=None)
    p.add_argument("--out", default="SR_results_testLR")
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    b_values = (0.0, 150.0, 1000.0, 1500.0)
    patients = []
    if args.master_mats:
        for path in args.master_mats:
            pt_id = os.path.basename(os.path.dirname(path)) or os.path.basename(path)
            hybrid, b = load_hybrid(path)
            patients.append((pt_id, hybrid, np.asarray(b).ravel()))
    else:
        data_dir = default_data_dir()
        for row in available_patients(data_dir)[: args.limit_patients]:
            pt_no = row["pt_id"].split("-")[-1]
            b0 = np.asarray(load_mat(os.path.join(data_dir, f"pat{pt_no}_mean_b0.mat"),
                                     "data_mean_b0"), dtype=np.float32)
            hybrid = synthetic.hybrid_from_b0(b0, b_values=b_values, seed=int(pt_no))
            patients.append((pt_no, hybrid, np.asarray(b_values)))
    if not patients:
        p.error("no patients found")

    r0, r1 = args.roi_start, args.roi_end
    for pt_id, hybrid, bvals in patients:
        out_dir = os.path.join(args.out, f"pat{pt_id}")
        os.makedirs(out_dir, exist_ok=True)
        mean_img = mean_images(hybrid, bvals)
        last = mean_img.shape[2]
        if args.limit_slices is not None:
            last = min(last, args.first_slice + args.limit_slices)
        for _slice in range(args.first_slice, last):
            for b in range(len(bvals)):
                lr = mean_img[r0:r1:2, r0:r1:2, _slice, b]
                _, ax = plt.subplots(1, 3, figsize=(30, 10))
                for axi in range(3):
                    ax[axi].imshow(lr, cmap="gray")
                    ax[axi].set_title(f"LR b={bvals[b]:g} $s/mm^2$")
                    ax[axi].axis("off")
                plt.savefig(os.path.join(out_dir, f"slice_{_slice}_b_{b}.png"),
                            bbox_inches="tight", pad_inches=0.2)
                plt.close()
        print(f"pat{pt_id}: panels in {out_dir}")
    print("Done")
    return args.out


if __name__ == "__main__":
    main()
