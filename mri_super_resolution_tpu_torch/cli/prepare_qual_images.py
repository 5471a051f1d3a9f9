"""Blinded qualitative-study panels (prepare_qual_images.py) on PyTorch.

Run as ``python -m mri_super_resolution_tpu_torch.cli.prepare_qual_images``.
The flags of the JAX package's ``cli/prepare_qual_images.py`` plus
``--device`` (default ``cuda``; raises when no card is present) and
``--data_dir``: the cases of the port's ``cli/inr_erd.py:build_cases``, a
shuffled low / interpolated / SR / base panel a chosen slice, written as
``<counter>.png`` with its row in ``labels.csv``, and with ``--score`` the
perceptual scores in ``perceptual_scores.csv``. The PNGs need matplotlib,
which the card's machine does not have: there the CLI stops, naming it,
before the first fit (``pipelines/qual_study.build_panel`` runs on the card
without it).
"""
from __future__ import annotations

import argparse
import os

from mri_super_resolution_tpu_torch.cli.inr_erd import build_cases
from mri_super_resolution_tpu_torch.pipelines import qual_study


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out_dir", default="qual")
    p.add_argument("--limit_cases", type=int, default=None)
    p.add_argument("--slices_per_case", type=int, default=1)
    p.add_argument("--num_acq", type=int, default=9)
    p.add_argument("--fine_tune_steps", type=int, default=500)
    p.add_argument("--start_counter", type=int, default=291)
    p.add_argument("--score", action="store_true", help="also run perceptual scoring")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    import matplotlib  # noqa: F401  (the PNG panels need it: fail before the first fit)

    cases = build_cases(args.limit_cases, args.num_acq, args.data_dir)
    if not cases:
        p.error("no cases found")
    labels, panels = qual_study.run(
        cases, args.out_dir, slices_per_case=args.slices_per_case, seed=args.seed,
        start_counter=args.start_counter, fine_tune_steps=args.fine_tune_steps,
        device=args.device)
    print(f"labels written to {labels} ({len(panels)} panels)")
    if args.score:
        out = qual_study.score_panels(
            panels, os.path.join(args.out_dir, "perceptual_scores.csv"), device=args.device)
        print(f"perceptual scores written to {out}")
    return labels


if __name__ == "__main__":
    main()
