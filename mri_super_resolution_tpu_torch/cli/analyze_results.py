"""Aggregate experiment CSVs into summary tables and barplots
(analyze_results.ipynb).

Run as ``python -m mri_super_resolution_tpu_torch.cli.analyze_results
<csv>``. The flags of the JAX package's ``cli/analyze_results.py``. It runs
on the CPU only: it does no tensor work, and needs pandas, matplotlib and
seaborn (``utils/analysis.py``).
"""
from __future__ import annotations

import argparse
import os

from mri_super_resolution_tpu_torch.utils import analysis


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("csv", help="metrics CSV (master.py schema)")
    p.add_argument("--metrics", nargs="*", default=["C", "CNR", "CNR2"])
    p.add_argument("--out_dir", default="analysis")
    args = p.parse_args(argv)

    df = analysis.load_contrast_csv(args.csv)
    os.makedirs(args.out_dir, exist_ok=True)
    for metric in args.metrics:
        summary = analysis.summarize_contrast(df, metric)
        print(f"== {metric}")
        print(summary.to_string())
        analysis.barplot_metric(df, metric, os.path.join(args.out_dir, f"{metric}.png"))
    print(f"plots in {args.out_dir}")
    return args.out_dir


if __name__ == "__main__":
    main()
