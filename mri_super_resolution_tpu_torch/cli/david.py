"""ERD-only contrast statistics (no INR), the david.py study, on PyTorch.

Run as ``python -m mri_super_resolution_tpu_torch.cli.david``. The flags of
the JAX package's ``cli/david.py`` and ``--device`` (default ``cuda``;
raises when no card is present). Cases come from ``$MRI_SR_DATA_DIR``
(``data/cases.load_cases``); see ``pipelines/erd_stats.py``.
"""
from __future__ import annotations

import argparse

from mri_super_resolution_tpu_torch.data import load_cases
from mri_super_resolution_tpu_torch.pipelines import erd_stats


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description="DAVID")
    p.add_argument("--out_folder", default="experiments/")
    p.add_argument("--experiment_name", default="david")
    p.add_argument("--limit_cases", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    cases = load_cases(limit=args.limit_cases)
    if not cases:
        p.error("no cases found")
    path = erd_stats.run(cases, args.out_folder, args.experiment_name, device=args.device)
    print(f"metrics written to {path}")
    return path


if __name__ == "__main__":
    main()
