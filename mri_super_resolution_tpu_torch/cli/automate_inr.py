"""FF-INR fit with periodic reconstruction snapshots (automate_INR.py) on
PyTorch.

Run as ``python -m mri_super_resolution_tpu_torch.cli.automate_inr``. The
toy perturbed acquisitions (toy2.mat's 256^2 x 50, or synthetic), a
Fourier mapping (128, scale 2.0) and a Siren(2*128 -> 128x3 -> 1) with
Adam at 1e-4: ``--mean_epochs`` epochs on the mean, then, with
``--use_pn``, alternating INR and per-acquisition PerturbNet epochs
(``fit/engine.fit_alternating_pn``; Adam 1e-6 for the PerturbNet), else
more epochs on the mean; the dense reconstruction is snapshotted every
``--snapshot_every`` epochs, and the last one and the stack are saved as a
.mat (``recon``, ``sr_epochs``). The optimizers carry their state across
the chunks, one schedule, as the JAX CLI carries ``opt_state``. The fits
are autograd over the plain models on ``--device`` (default ``cuda``;
raises when no card is present), as the JAX CLI fits by autodiff: no
kernel.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from mri_super_resolution_tpu_torch import resolve_device, set_float32_precision
from mri_super_resolution_tpu_torch.core.coords import fourier_encode, fourier_matrix, mgrid
from mri_super_resolution_tpu_torch.data import load_mat, save_mat, synthetic
from mri_super_resolution_tpu_torch.fit.engine import (
    fit_alternating_pn,
    fit_simple,
    infer_grid,
    plain_apply,
)
from mri_super_resolution_tpu_torch.fit.optim import Adam
from mri_super_resolution_tpu_torch.models import PerturbNet, Siren, perturbnet_apply


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--toy_mat", default=None, help="toy2.mat with 'pertubed_acq'")
    p.add_argument("--side", type=int, default=256)
    p.add_argument("--num_acq", type=int, default=50)
    p.add_argument("--mapping_size", type=int, default=128)
    p.add_argument("--ff_scale", type=float, default=2.0)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--epochs", type=int, default=2000)
    p.add_argument("--mean_epochs", type=int, default=500)
    p.add_argument("--snapshot_every", type=int, default=100)
    p.add_argument("--use_pn", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    set_float32_precision()

    if args.toy_mat:
        acqs = np.asarray(load_mat(args.toy_mat, "pertubed_acq"), dtype=np.float32)
    else:
        acqs = synthetic.toy_perturbed_acquisitions(args.side, args.num_acq, args.seed)
    side = acqs.shape[0]
    mean_img = acqs.mean(-1)
    mean_img = mean_img / mean_img.max()

    gen = torch.Generator().manual_seed(args.seed)
    B = fourier_matrix(gen, args.mapping_size, 2, scale=args.ff_scale, device=dev)
    coords = mgrid((side, side), device=dev)
    ff = fourier_encode(coords, B)
    target = torch.as_tensor(mean_img.reshape(-1, 1), device=dev)

    inr = Siren(2 * args.mapping_size, args.hidden, args.layers, generator=gen, device=dev)
    inr.requires_grad_(False)
    inr_apply = plain_apply(inr)
    opt = Adam(inr.weights(), 1e-4)
    snapshots = []

    def snapshot():
        rec = infer_grid(inr_apply, opt.params, coords, fourier_B=B)
        snapshots.append(rec.reshape(side, side).cpu().numpy())

    done = 0
    if args.use_pn:
        acq_pixels = torch.as_tensor(
            (np.moveaxis(acqs, -1, 0) / acqs.max()).reshape(acqs.shape[-1], -1, 1), device=dev)
        pn = PerturbNet(2 * args.mapping_size, args.hidden, dimension=2, generator=gen,
                        device=dev)
        pn.requires_grad_(False)
        pn_opt = Adam(pn.weights(), 1e-6)
    while done < args.epochs:
        chunk = min(args.snapshot_every, args.epochs - done)
        if args.use_pn and done >= args.mean_epochs:
            res = fit_alternating_pn(inr_apply, perturbnet_apply, opt, pn_opt, ff, target,
                                     acq_pixels, B, num_epochs=chunk, pn_epochs=chunk)
        else:
            if args.use_pn:
                # the mean phase runs exactly mean_epochs steps: a chunk that
                # straddles the boundary is cut at it
                chunk = min(chunk, args.mean_epochs - done)
            res = fit_simple(inr_apply, opt, ff, target, chunk)
        done += chunk
        snapshot()
        print(f"epoch {done}: loss {float(res.losses[-1]):.3e}")

    out = args.out or f"nonPILoutput_b_{args.ff_scale}_emb_{args.mapping_size}.mat"
    save_mat(out, {"recon": snapshots[-1], "sr_epochs": np.stack(snapshots, -1)})
    print(f"saved {out} ({len(snapshots)} snapshots)")
    return out


if __name__ == "__main__":
    main()
