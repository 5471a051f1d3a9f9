"""Train the RAMS multi-image SR network on DWI acquisitions, on PyTorch.

Run as ``python -m mri_super_resolution_tpu_torch.cli.train_misr``. Same
flags as the JAX package's ``cli/train_misr.py`` (``--data_parallel``
raises: data parallelism is ROADMAP item 25), plus ``--device`` (default
``cuda``; raises without a card), ``--conv_kernel`` (the 3x3x3 32-channel
convs on K6 forward and K7 backward), ``--compute_dtype`` (default
bfloat16, as ``RAMSConfig``) and ``--log_dir`` (the scalar CSV and
TensorBoard runs; default ``logs``, as ``TrainerConfig``). The training set
is built as the JAX package builds it: HR patches of the mean-b0 volumes in
``$MRI_SR_DATA_DIR`` (default ``anon_data``), LR stacks of shifted noisy
synthetic acquisitions at 1/scale resolution. The initial params are drawn
from ``--seed``; checkpoints (the port's own format) go to ``--ckpt_dir``
and serve through ``cli/misr_master.py --ckpt <dir>``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mri_super_resolution_tpu_torch.config import RAMSConfig, TrainerConfig
from mri_super_resolution_tpu_torch.data import (available_patients, default_data_dir,
                                                 load_mat, synthetic)
from mri_super_resolution_tpu_torch.fit.trainer import Trainer
from mri_super_resolution_tpu_torch.pipelines.misr import build_rams
from mri_super_resolution_tpu_torch.utils.checkpoint import CheckpointManager


def build_dataset(hr_size: int = 96, T: int = 9, limit_patients: int | None = None,
                  patches_per_slice: int = 4, seed: int = 0, scale: int = 3):
    """HR patches + simulated LR acquisition stacks from the data volumes
    (the JAX package's ``build_dataset``, the same arrays for the same
    files and seed).

    HR: ``hr_size`` crops of mean-b0 slices scaled to the uint16 range
    (x256, as the MISR inference script does, master.py:42-43). LR:
    block-averaged ``scale``x downsamples with ``T`` shifted Rician-noisy
    copies (``data/synthetic.py``'s acquisition model)."""
    rng = np.random.default_rng(seed)
    data_dir = default_data_dir()
    lr_size = hr_size // scale

    X, Y, pids = [], [], []
    rows = available_patients(data_dir)[:limit_patients]
    for pi, row in enumerate(rows):
        pt_no = row["pt_id"].split("-")[-1]
        vol = np.asarray(load_mat(os.path.join(data_dir, f"pat{pt_no}_mean_b0.mat"),
                                  "data_mean_b0"), dtype=np.float32)
        H, W, S = vol.shape
        for s in range(4, S - 4, 2):
            img = vol[:, :, s] * 256.0
            for _ in range(patches_per_slice):
                y0 = rng.integers(0, H - hr_size)
                x0 = rng.integers(0, W - hr_size)
                hr = img[y0:y0 + hr_size, x0:x0 + hr_size]
                if hr.mean() < 10.0:  # skip empty background patches
                    continue
                lr_base = hr.reshape(lr_size, scale, lr_size, scale).mean((1, 3))
                stack = synthetic.acquisitions_from_b0(
                    lr_base[:, :, None] / 256.0, num_acq=T,
                    seed=int(rng.integers(1 << 31)), noise_sigma_frac=0.02,
                    outlier_prob=0.0,
                )[:, :, 0, :] * 256.0
                X.append(stack.astype(np.float32))
                Y.append(hr[..., None].astype(np.float32))
                pids.append(pi)
    X = np.stack(X)
    Y = np.stack(Y)
    return X, Y, np.ones_like(Y), np.asarray(pids)


def split_dataset(X, Y, M, pids, holdout_patients: int = 1):
    """Patient-held-out train/val split: the last ``holdout_patients``
    patients' patches are the validation set."""
    if holdout_patients < 1:
        raise ValueError("holdout_patients must be >= 1 (0 would hold out "
                         "EVERY patient: numpy's [-0:] is the full array)")
    val_ids = set(np.unique(pids)[-holdout_patients:].tolist())
    v = np.asarray([p in val_ids for p in pids])
    t = ~v
    return (X[t], Y[t], M[t]), (X[v], Y[v], M[v])


def main(argv=None) -> Trainer:
    p = argparse.ArgumentParser(description="Train RAMS on DWI (PyTorch)")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--hr_size", type=int, default=96)
    p.add_argument("--filters", type=int, default=32)
    p.add_argument("--N", type=int, default=12)
    p.add_argument("--limit_patients", type=int, default=None)
    p.add_argument("--patches_per_slice", type=int, default=4)
    p.add_argument("--evaluate_every", type=int, default=20)
    p.add_argument("--ckpt_dir", default=os.path.join("artifacts", "rams_dwi_torch"))
    p.add_argument("--log_dir", default="logs")
    p.add_argument("--data_aug", action="store_true")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--lr_schedule", choices=("constant", "cosine"), default="constant")
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--ema_decay", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--split", choices=("patient", "sequential"), default="patient")
    p.add_argument("--holdout_patients", type=int, default=1)
    p.add_argument("--data_parallel", action="store_true",
                   help="not ported: raises (ROADMAP item 25)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--conv_kernel", action="store_true",
                   help="run the 3x3x3 convs with 8k channels on K6 and K7")
    p.add_argument("--compute_dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = p.parse_args(argv)
    if args.data_parallel:
        raise NotImplementedError(
            "--data_parallel is not ported to PyTorch yet (ROADMAP Queue 1, item 25)")

    X, Y, M, pids = build_dataset(hr_size=args.hr_size, limit_patients=args.limit_patients,
                                  patches_per_slice=args.patches_per_slice, seed=args.seed)
    if args.split == "patient":
        (Xt, Yt, Mt), (Xv, Yv, Mv) = split_dataset(
            X, Y, M, pids, holdout_patients=args.holdout_patients)
    else:
        # the first 10% of patches, independent of batch_size
        n_val = max(8, len(X) // 10)
        Xt, Yt, Mt = X[n_val:], Y[n_val:], M[n_val:]
        Xv, Yv, Mv = X[:n_val], Y[:n_val], M[:n_val]
    print(f"dataset: {len(Xt)} train / {len(Xv)} val patches ({args.split} split), "
          f"LR {Xt.shape[1:]} HR {Yt.shape[1:]}")

    model = build_rams(RAMSConfig(filters=args.filters, N=args.N,
                                  compute_dtype=args.compute_dtype,
                                  conv_kernel=args.conv_kernel),
                       generator=torch.Generator().manual_seed(args.seed))
    micro_per_epoch = -(-len(Xt) // args.batch_size)
    steps_per_epoch = -(-micro_per_epoch // args.grad_accum)
    # a resumed cosine run restores the schedule's count: anchor the decay
    # horizon at the restored step plus this run's steps
    restored_step = 0
    if args.lr_schedule == "cosine":
        restored_step = CheckpointManager(args.ckpt_dir).latest_step() or 0
        if restored_step:
            print(f"cosine schedule resumes from step {restored_step}; "
                  f"decay extended to {restored_step + args.epochs * steps_per_epoch}")
    cfg = TrainerConfig(
        batch_size=args.batch_size, epochs=args.epochs, hr_size=args.hr_size,
        evaluate_every=args.evaluate_every, checkpoint_dir=os.path.abspath(args.ckpt_dir),
        log_dir=args.log_dir, data_aug=args.data_aug, learning_rate=args.learning_rate,
        lr_schedule=args.lr_schedule, ema_decay=args.ema_decay, grad_accum=args.grad_accum,
        decay_steps=restored_step + args.epochs * steps_per_epoch,
    )
    trainer = Trainer(model, cfg, device=args.device)
    trainer.init()
    trainer.fit(Xt, (Yt, Mt), validation_data=(Xv, Yv, Mv), seed=args.seed)
    val_psnr = trainer.evaluate(Xv, Yv, Mv)
    print(f"final val cPSNR: {val_psnr:.2f} dB; checkpoints in {cfg.checkpoint_dir}")
    return trainer


if __name__ == "__main__":
    main()
