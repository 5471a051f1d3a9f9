"""Multi-image SR inference over the case registry (the MISR master.py) on
PyTorch.

Run as ``python -m mri_super_resolution_tpu_torch.cli.misr_master``. Same
flags as the JAX package's ``cli/misr_master.py`` plus ``--device`` (default
``cuda``; raises when no card is present) and ``--conv_kernel`` (the 3x3x3
32-channel convs on K6). ``--ckpt`` takes a ``.npz`` of RAMS params
(``convert.save_params_npz``); at the reference architecture (32, 12) the
committed checkpoint is the default, and ``--allow_untrained`` runs with
fresh weights drawn from ``--seed``. Cases come from ``$MRI_SR_DATA_DIR``
(default ``anon_data``).
"""
from __future__ import annotations

import argparse
import os

import torch

from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.config import RAMSConfig
from mri_super_resolution_tpu_torch.data import load_cases
from mri_super_resolution_tpu_torch.pipelines import misr


def main(argv=None):
    p = argparse.ArgumentParser(description="Superresolution of DWI/ADC maps with "
                                "Multi-image SR")
    p.add_argument("--out_img_folder", default="output_images.mi/")
    p.add_argument("--exp_name", default="sr2")
    p.add_argument("--ckpt", default=None, help=".npz of RAMS params")
    p.add_argument("--allow_untrained", action="store_true")
    p.add_argument("--sample_size", type=int, default=25)
    p.add_argument("--limit_cases", type=int, default=None)
    p.add_argument("--filters", type=int, default=32)
    p.add_argument("--N", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--conv_kernel", action="store_true",
                   help="run the 3x3x3 convs with 8k channels on K6 (conv3d_rfab)")
    args = p.parse_args(argv)

    cfg = RAMSConfig(filters=args.filters, N=args.N, conv_kernel=args.conv_kernel)
    if args.ckpt is None and not args.allow_untrained:
        if (args.filters, args.N) == (32, 12) and os.path.isfile(convert.RAMS_PARAMS_NPZ):
            args.ckpt = convert.RAMS_PARAMS_NPZ
            print(f"restoring committed pretrained params: {args.ckpt}")
    if args.ckpt:
        state_dict = convert.rams_state_dict(convert.load_params_npz(args.ckpt))
    elif args.allow_untrained:
        gen = torch.Generator().manual_seed(args.seed)
        state_dict = misr.build_rams(cfg, generator=gen).state_dict()
        print("WARNING: running with untrained weights (--allow_untrained)")
    else:
        p.error("provide --ckpt or pass --allow_untrained")

    cases = load_cases(limit=args.limit_cases)
    if not cases:
        p.error("no cases found")
    misr.run(cases, cfg, state_dict, args.out_img_folder, args.exp_name,
             sample_size=args.sample_size, seed=args.seed, device=args.device)
    print(f"wrote DICOMs under {args.out_img_folder}/{args.exp_name}")


if __name__ == "__main__":
    main()
