"""Synthetic half-resolution quality protocol (superres-lowres(-qual).ipynb)
on PyTorch.

Run as ``python -m mri_super_resolution_tpu_torch.cli.superres_lowres``.
Downsamples each slice's acquisition mean 0.5x, super-resolves it back with
the two-phase perturbed INR and scores SR and spline against the
full-resolution mean (``pipelines/lowres_qual.py``). The flags of the JAX
package's ``cli/superres_lowres.py`` and ``--device`` (default ``cuda``;
raises when no card is present). Cases are built as ``cli/inr_erd.py``
builds them.
"""
from __future__ import annotations

import argparse

from mri_super_resolution_tpu_torch.cli.inr_erd import build_cases
from mri_super_resolution_tpu_torch.data import MetricsCSV
from mri_super_resolution_tpu_torch.pipelines import lowres_qual


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--limit_cases", type=int, default=None)
    p.add_argument("--num_acq", type=int, default=9)
    p.add_argument("--slices", type=int, nargs="*", default=None,
                   help="slice indices (default: every slice, qual-notebook style)")
    p.add_argument("--cancer_slice_only", action="store_true",
                   help="just each case's cancer slice (superres-lowres.ipynb cell 6)")
    p.add_argument("--phase2_steps", type=int, default=500)
    p.add_argument("--loss_threshold", type=float, default=2e-5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_csv", default="lowres_qual.csv")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--split_protocol", action="store_true",
                   help="ground truth from a held-out half of the "
                        "acquisitions (noise independent of both arms)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    cfg = lowres_qual.LowresQualConfig(
        phase2_steps=args.phase2_steps, loss_threshold=args.loss_threshold,
        split_protocol=args.split_protocol)
    cases = build_cases(args.limit_cases, args.num_acq, args.data_dir)
    if not cases:
        p.error("no cases found")

    if args.cancer_slice_only:
        csv = MetricsCSV(args.out_csv, lowres_qual.LOWRES_QUAL_HEADER)
        for case in cases:
            res = lowres_qual.run_slice(case, case.cancer_slice, cfg, seed=args.seed,
                                        device=args.device)
            lowres_qual.append_row(csv, case.pt_id, case.cancer_slice, res.metrics)
            print(f"{case.pt_id}: SSIM spline {res.metrics[0]:.4f} SR {res.metrics[1]:.4f} "
                  f"({res.pretrain_steps} pretrain steps)")
        path = csv.path
    else:
        path = lowres_qual.run(cases, cfg, args.out_csv, slices=args.slices, seed=args.seed,
                               device=args.device)
    print(f"metrics written to {path}")
    return path


if __name__ == "__main__":
    main()
