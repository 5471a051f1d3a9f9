"""WIRE vs SIREN on a single DWI slice: the wiretest.ipynb capability.

Counterpart of the JAX package's ``examples/wire_vs_siren.py``. Reference:
implicit-neural-representations/wiretest.ipynb fits the complex-Gabor WIRE
INR (INRmodel.py:66-120) to a slice and takes the real part of the output.
Here both INR families fit the same slice (slice 14 of
``pat07_mean_b0.mat`` under ``$MRI_SR_DATA_DIR``, default ``anon_data``;
``data/synthetic.toy_image(128)`` when it is missing) with
``fit/engine.fit_simple`` and report PSNR against a bicubic baseline. The
fits are autograd over the plain models on ``--device``, as the JAX
example fits by autodiff: no kernel.

Run: ``python -m mri_super_resolution_tpu_torch.examples.wire_vs_siren
[--steps 800] [--hidden 128] [--seed 0] [--device cuda]``
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mri_super_resolution_tpu_torch import resolve_device, set_float32_precision
from mri_super_resolution_tpu_torch.core.coords import mgrid
from mri_super_resolution_tpu_torch.core.interp import rescale
from mri_super_resolution_tpu_torch.core.metrics import psnr
from mri_super_resolution_tpu_torch.data import default_data_dir, load_mat, synthetic
from mri_super_resolution_tpu_torch.fit.engine import fit_simple, plain_apply
from mri_super_resolution_tpu_torch.fit.optim import Adam
from mri_super_resolution_tpu_torch.models import Siren, Wire, wire_apply


def load_slice() -> np.ndarray:
    path = os.path.join(default_data_dir(), "pat07_mean_b0.mat")
    if os.path.exists(path):
        vol = np.asarray(load_mat(path, "data_mean_b0"), dtype=np.float32)
        img = vol[:, :, 14]
    else:
        img = synthetic.toy_image(128)
    return img / img.max()


def main(argv=None, img: np.ndarray | None = None) -> dict:
    """``img`` replaces the slice (a caller's small run); returns each
    model's (final loss, PSNR)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the fits run (default cuda; raises when no card is present)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    set_float32_precision()

    img = load_slice() if img is None else img
    H, W = img.shape
    coords = mgrid((H, W), device=dev)
    img_t = torch.as_tensor(np.ascontiguousarray(img), dtype=torch.float32)
    target = img_t.reshape(-1, 1).to(dev)

    # bicubic reference point: downsample 2x and spline back up, the
    # trivial interpolation any INR fit must beat (wiretest.ipynb baseline)
    lr_img = rescale(img_t, 0.5, anti_aliasing=True)
    bicubic = rescale(lr_img, 2, anti_aliasing=True)[:H, :W]
    print(f"bicubic(2x) baseline: PSNR {float(psnr(img_t, bicubic)):.2f} dB")

    gen = torch.Generator().manual_seed(args.seed)
    siren = Siren(2, args.hidden, 2, generator=gen, device=dev)
    wire = Wire(2, args.hidden, 2, generator=gen, device=dev)
    # omega and sigma stay fixed (trainable=False): the fit trains the weights
    scales = [s.detach() for s in wire.scales()]

    def wire_fixed(weights, x):
        return wire_apply(list(weights) + scales, x, n_hidden=2)

    results = {}
    for name, params, apply_fn, lr in (
        ("SIREN", siren.weights(), plain_apply(siren), 3e-4),
        ("WIRE", wire.weights(), wire_fixed, 5e-3),
    ):
        params = [q.detach() for q in params]
        res = fit_simple(apply_fn, Adam(params, lr), coords, target, args.steps)
        with torch.no_grad():
            recon = apply_fn(res.params, coords).reshape(H, W).cpu()
        results[name] = (float(res.losses[-1]), float(psnr(img_t, recon)))
        print(f"{name}: final loss {results[name][0]:.3e}, PSNR {results[name][1]:.2f} dB")
    return results


if __name__ == "__main__":
    main()
