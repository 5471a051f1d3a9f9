"""PIA training and tissue-map inference on PyTorch.

Run as ``python -m mri_super_resolution_tpu_torch.cli.pia``. Same flags as
the JAX package's ``cli/pia.py`` plus ``--device`` (default ``cuda``;
raises when no card is present): pretrain on synthetic 3-compartment draws,
optionally fine-tune unsupervised on real voxels with PIDS weights, write
D/T2/v maps, and save the model's state dict with ``torch.save`` at
``--out`` (the ``superres_hybrid`` CLI's ``--pia_ckpt``).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mri_super_resolution_tpu_torch import resolve_device
from mri_super_resolution_tpu_torch.models import PIA
from mri_super_resolution_tpu_torch.pipelines import pia_train


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--noise_std", type=float, default=0.1)
    p.add_argument("--noise_range", type=float, nargs=2, default=None,
                   metavar=("LO", "HI"),
                   help="train with per-voxel sigma log-uniform in [LO, HI] "
                   "(one encoder for all noise levels) instead of --noise_std")
    p.add_argument("--unsupervised", action="store_true",
                   help="signal-only loss instead of supervised D/T2/v loss")
    p.add_argument("--finetune_hybrid", default=None,
                   help="npz with 'signals' (N, 16) real voxels for PIDS fine-tune")
    p.add_argument("--finetune_steps", type=int, default=500)
    p.add_argument("--out", default="pia_model.pt")
    p.add_argument("--maps_out", default=None, help="npz path for D/T2/v maps")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    if args.maps_out and not args.finetune_hybrid:
        p.error("--maps_out needs voxel signals: pass --finetune_hybrid too")

    dev = resolve_device(args.device)
    model = PIA(generator=torch.Generator().manual_seed(args.seed), device=dev)
    res = pia_train.train_synthetic(
        model, torch.Generator(dev).manual_seed(args.seed), steps=args.steps,
        batch_size=args.batch_size, lr=args.lr, noise_std=args.noise_std,
        noise_range=tuple(args.noise_range) if args.noise_range else None,
        supervised=not args.unsupervised)
    print(f"pretrain: loss {float(res.losses[0]):.4f} -> {float(res.losses[-1]):.4f}")

    if args.finetune_hybrid:
        data = np.load(args.finetune_hybrid)
        signals = torch.as_tensor(data["signals"], dtype=torch.float32, device=dev)
        pids = (torch.as_tensor(data["pids"], dtype=torch.float32, device=dev)
                if "pids" in data else torch.ones_like(signals))
        ft = pia_train.finetune_on_voxels(model, signals, pids, steps=args.finetune_steps)
        print(f"fine-tune: loss {float(ft.losses[0]):.4f} -> {float(ft.losses[-1]):.4f}")
        if args.maps_out:
            D, T2, v = (t.cpu().numpy() for t in pia_train.predict_maps(model, signals))
            np.savez(args.maps_out, D=D, T2=T2, v=v)
            print(f"maps written to {args.maps_out}")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(model.state_dict(), args.out)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
