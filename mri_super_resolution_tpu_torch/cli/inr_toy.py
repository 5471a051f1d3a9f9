"""Smallest runnable INR fit (inr_toy.py) on PyTorch.

Run as ``python -m mri_super_resolution_tpu_torch.cli.inr_toy``. Fits a
``SirenToy(2 -> 128x3)`` to the mean of toy perturbed acquisitions in
``--check_every``-step chunks of ``fit/engine.fit_simple``, stops early when
a chunk's last loss rises (after step 100) or falls below 1e-9, samples
the fit on the grid and saves the model's ``state_dict`` with
``torch.save`` (the JAX package's ``cli/inr_toy.py`` writes orbax). The
fit is autograd over the plain model on ``--device`` (default ``cuda``;
raises when no card is present), as the JAX CLI fits by autodiff: no
kernel.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mri_super_resolution_tpu_torch import resolve_device, set_float32_precision
from mri_super_resolution_tpu_torch.core.coords import mgrid
from mri_super_resolution_tpu_torch.data import load_mat, synthetic
from mri_super_resolution_tpu_torch.fit.engine import fit_simple, infer_grid, plain_apply
from mri_super_resolution_tpu_torch.fit.optim import Adam
from mri_super_resolution_tpu_torch.models import SirenToy


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--toy_mat", default=None, help="optional toy.mat with 'pertubed_acq'")
    p.add_argument("--side", type=int, default=128)
    p.add_argument("--num_acq", type=int, default=20)
    p.add_argument("--hidden_features", type=int, default=128)
    p.add_argument("--hidden_layers", type=int, default=3)
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--check_every", type=int, default=100)
    p.add_argument("--max_steps", type=int, default=5000)
    p.add_argument("--out", default="toy_model.pt")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    set_float32_precision()

    if args.toy_mat:
        acquisitions = 1 - np.asarray(load_mat(args.toy_mat, "pertubed_acq"), dtype=np.float32)
    else:
        acquisitions = synthetic.toy_perturbed_acquisitions(args.side, args.num_acq, args.seed)
    mean_img = acquisitions.mean(-1)
    mean_img = mean_img / mean_img.max()
    side = mean_img.shape[0]

    coords = mgrid(mean_img.shape, device=dev)
    target = torch.as_tensor(mean_img.reshape(-1, 1), device=dev)
    model = SirenToy(2, args.hidden_features, args.hidden_layers,
                     generator=torch.Generator().manual_seed(args.seed), device=dev)
    model.requires_grad_(False)
    apply_fn = plain_apply(model)
    opt = Adam(model.weights(), args.learning_rate)

    # the loss-increase early stop (inr_toy.py:97-100), checked per chunk
    prev = np.inf
    t0 = time.perf_counter()
    total = 0
    while total < args.max_steps:
        res = fit_simple(apply_fn, opt, coords, target, args.check_every)
        loss = float(res.losses[-1])
        total += args.check_every
        print(f"step {total}: loss {loss:.3e}")
        if (loss > prev and total > 100) or loss < 1e-9:
            break
        prev = loss
    dt = time.perf_counter() - t0

    recon = infer_grid(apply_fn, opt.params, mgrid((side, side), device=dev))
    recon = recon.reshape(side, side).cpu().numpy()
    mse = float(np.mean((recon - mean_img) ** 2))
    vox_per_sec = total * coords.shape[0] / dt
    print(f"final mse {mse:.3e}; {vox_per_sec:,.0f} voxels/sec over {total} steps")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(model.state_dict(), args.out)
    print(f"saved {args.out}")
    return mse


if __name__ == "__main__":
    main()
