"""Directional 2-D INR super-resolution with AutoERD (master.py) on PyTorch.

Run as ``python -m mri_super_resolution_tpu_torch.cli.master``. The flags of
the JAX package's ``cli/master.py`` (those of master.py:25-41 plus
``--limit_cases`` and ``--data_dir``) and ``--device`` (default ``cuda``;
raises when no card is present). Cases come from ``--data_dir``, else
``$MRI_SR_DATA_DIR`` (default ``anon_data``).
"""
from __future__ import annotations

import argparse

from mri_super_resolution_tpu_torch.config import Master2DConfig
from mri_super_resolution_tpu_torch.data import load_cases
from mri_super_resolution_tpu_torch.pipelines import master2d


def main(argv=None) -> str:
    p = argparse.ArgumentParser(
        description="Superresolution of DWI/ADC maps enhanced with AutoERD")
    p.add_argument("--out_folder", default="experiments/")
    p.add_argument("--out_img_folder", default="output_images/")
    p.add_argument("--total_steps", type=int, default=3000)
    p.add_argument("--seg", type=int, default=150)
    p.add_argument("--hidden_layers", type=int, default=6)
    p.add_argument("--hidden_features", type=int, default=64)
    p.add_argument("--ROI_begin", type=int, default=40)
    p.add_argument("--ROI_end", type=int, default=100)
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--scale", type=int, default=3)
    p.add_argument("--exp_name", default="sr2")
    p.add_argument("--repeat_time", type=int, default=1)
    p.add_argument("--erd", type=int, default=0, choices=(0, 1, 2))
    p.add_argument("--limit_cases", type=int, default=None)
    p.add_argument("--data_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    cfg = Master2DConfig(
        out_folder=args.out_folder,
        out_img_folder=args.out_img_folder,
        total_steps=args.total_steps,
        seg=args.seg,
        hidden_layers=args.hidden_layers,
        hidden_features=args.hidden_features,
        roi_begin=args.ROI_begin,
        roi_end=args.ROI_end,
        learning_rate=args.learning_rate,
        scale=args.scale,
        exp_name=args.exp_name,
        repeat_time=args.repeat_time,
        erd=args.erd,
    )
    cases = load_cases(data_dir=args.data_dir, limit=args.limit_cases)
    if not cases:
        p.error("no cases found (check --data_dir)")
    csv_path = master2d.run(cfg, cases, device=args.device)
    print(f"metrics written to {csv_path}")
    return csv_path


if __name__ == "__main__":
    main()
