"""Export a fitted model as a self-contained serving artifact (torch.export).

Run as ``python -m mri_super_resolution_tpu_torch.cli.export_model
{inr,rams,grid,pia}``. The subcommands and flags of the JAX package's
``cli/export_model.py``, with ``--device`` (default ``cuda``; raises when no
card is present) in place of ``--platforms``: export on the card writes a
``cuda`` and a ``cpu`` program, on the CPU a ``cpu`` one
(``serve.py``). ``--params`` reads the port's own checkpoints, never
orbax: the ``torch.save`` state dicts of ``inr_toy --out`` (``inr``),
``pia --out`` (``pia``) and of a ``GridINR`` (``grid``); for ``rams`` the
committed ``artifacts/rams_dwi_params.npz`` by default, another ``.npz``
of RAMS params, a trainer ``<step>.pt`` or a trainer checkpoint directory.

The artifacts carry the plain modules, as the JAX artifacts carry plain
XLA: the INRs' PyTorch forward, the RAMS on the library convolutions in
bf16 (``conv_kernel=False``), no hand-written kernel. ``--check`` serves
the artifact on ``--device`` and compares it with the live model on the
same inputs, at the JAX CLI's bars: max error over the largest magnitude
1e-4 for the INRs, the GridINR and PIA, ``--check_tol`` (2e-2) for the
bf16 RAMS.

Examples::

  python -m mri_super_resolution_tpu_torch.cli.export_model inr --params toy_model.pt \\
      --out toy_art --check
  python -m mri_super_resolution_tpu_torch.cli.export_model rams --out rams_art --check
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mri_super_resolution_tpu_torch import convert, resolve_device, serve, set_float32_precision
from mri_super_resolution_tpu_torch.config import RAMSConfig
from mri_super_resolution_tpu_torch.core.coords import fourier_encode
from mri_super_resolution_tpu_torch.models import PIA, GridINR, Siren, SirenToy, Wire
from mri_super_resolution_tpu_torch.models.grid_inr import infer_tensor_grid
from mri_super_resolution_tpu_torch.pipelines.misr import load_model
from mri_super_resolution_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                             unwrap_trainer_params)

INR_TOL = 1e-4  # the INRs, the GridINR and PIA: float32 programs


def _rel_err(got, want) -> float:
    """Max |got - want| over the largest |want|, over every output."""
    pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
    return max(float((torch.as_tensor(g).cpu() - w.cpu()).abs().max())
               / max(float(w.abs().max()), 1e-12) for g, w in pairs)


def _check(out: str, device, live_fn, inputs, tol: float, what: str = "") -> float:
    """Serve the artifact on ``device`` and compare it with the live model;
    exits with 1 past ``tol``. The two are separately traced programs, so
    bit-identity is not expected."""
    served = serve.load(out, device=device)
    with torch.no_grad():
        err = _rel_err(served(*inputs), live_fn(*inputs))
    status = "OK" if err <= tol else "MISMATCH"
    print(f"roundtrip check{what}: max rel err {err:.2e} [{status}]")
    if status != "OK":
        raise SystemExit(1)
    return err


def _rams_state_dict(path: str | None) -> dict:
    path = path or convert.RAMS_PARAMS_NPZ
    if path.endswith(".npz"):
        return convert.rams_state_dict(convert.load_params_npz(path))
    if os.path.isdir(path):
        tree = CheckpointManager(path).restore()
        if tree is None:
            raise SystemExit(f"no checkpoint under {path}")
    else:
        tree = torch.load(path, map_location="cpu", weights_only=True)
    return unwrap_trainer_params(tree)


def _state_dict(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="kind", required=True)

    def common(sp):
        sp.add_argument("--out", required=True)
        sp.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card; writes cuda and cpu "
                        "programs) or 'cpu'")
        sp.add_argument("--check", action="store_true", help="roundtrip-verify the artifact")

    pi = sub.add_parser("inr", help="coordinate-INR artifact: (n, d) -> (n, out)")
    pi.add_argument("--params", required=True, help="torch.save state dict (inr_toy --out)")
    pi.add_argument("--model", choices=["siren", "siren_toy", "wire"], default="siren_toy")
    pi.add_argument("--hidden_features", type=int, default=128)
    pi.add_argument("--hidden_layers", type=int, default=3)
    pi.add_argument("--coord_dim", type=int, default=2)
    pi.add_argument("--out_features", type=int, default=1)
    pi.add_argument("--first_omega_0", type=float, default=30.0)
    pi.add_argument("--hidden_omega_0", type=float, default=30.0)
    pi.add_argument("--omega_0", type=float, default=10.0, help="wire only")
    pi.add_argument("--sigma_0", type=float, default=10.0, help="wire only")
    pi.add_argument("--fourier_B", default=None, help="optional .npy Fourier matrix")
    common(pi)

    pr = sub.add_parser("rams", help="RAMS artifact: (b, H, W, T) -> (b, sH, sW, 1)")
    pr.add_argument("--params", default=None,
                    help=".npz of RAMS params (default: the committed "
                    "artifacts/rams_dwi_params.npz), a trainer <step>.pt or checkpoint dir")
    pr.add_argument("--height", type=int, default=96)
    pr.add_argument("--width", type=int, default=96)
    pr.add_argument("--filters", type=int, default=32)
    pr.add_argument("--N", type=int, default=12)
    pr.add_argument("--channels", type=int, default=9)
    pr.add_argument("--check_tol", type=float, default=2e-2,
                    help="roundtrip max-rel-err bound: the artifact and the live model are "
                    "separately traced bf16 programs")
    common(pr)

    pg = sub.add_parser("grid", help="GridINR artifact: (x, y, z) axis-coordinate vectors "
                        "-> (nx, ny, nz, nb, out); all axis lengths symbolic")
    pg.add_argument("--params", required=True, help="torch.save state dict of a GridINR")
    pg.add_argument("--levels", type=int, default=4)
    pg.add_argument("--base_resolution", type=int, default=8)
    pg.add_argument("--features", type=int, default=4)
    pg.add_argument("--hidden", type=int, default=64)
    pg.add_argument("--z_divisor", type=int, default=1,
                    help="1 matches the quality preset / superres3d ROI fits")
    common(pg)

    pp = sub.add_parser("pia", help="PIA tissue-fitter artifact: signals (n, S) -> (D, T2, v)")
    pp.add_argument("--params", required=True, help="torch.save state dict (pia --out)")
    pp.add_argument("--number_of_signals", type=int, default=16)
    common(pp)

    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    set_float32_precision()
    gen = torch.Generator().manual_seed(0)

    if args.kind == "inr":
        B = None if args.fourier_B is None else torch.as_tensor(
            np.load(args.fourier_B), dtype=torch.float32, device=dev)
        in_f = args.coord_dim if B is None else 2 * B.shape[0]
        if args.model == "wire":
            if args.out_features != 1:
                p.error("wire has one output (the port's Wire)")
            model = Wire(in_f, args.hidden_features, args.hidden_layers,
                         omega_0=args.omega_0, sigma_0=args.sigma_0, device=dev)
        else:
            cls = {"siren": Siren, "siren_toy": SirenToy}[args.model]
            model = cls(in_f, args.hidden_features, args.hidden_layers, args.out_features,
                        args.first_omega_0, args.hidden_omega_0, device=dev)
        model.load_state_dict(_state_dict(args.params))
        model.requires_grad_(False)
        manifest = serve.export_inr(
            model, args.coord_dim, args.out, fourier_B=B, out_features=args.out_features,
            device=dev, model_desc=f"{args.model} {args.hidden_features}x{args.hidden_layers}")
        coords = (torch.rand(257, args.coord_dim, generator=gen) * 2 - 1).to(dev)
        live, inputs, tol, what = lambda c: model(fourier_encode(c, B)), [coords], INR_TOL, ""
    elif args.kind == "grid":
        model = GridINR(num_levels=args.levels, base_resolution=args.base_resolution,
                        features_per_level=args.features, hidden=args.hidden,
                        z_divisor=args.z_divisor, device=dev)
        model.load_state_dict(_state_dict(args.params))
        model.requires_grad_(False)
        manifest = serve.export_grid_inr(
            model, args.out, device=dev,
            model_desc=(f"grid_inr L{args.levels} R{args.base_resolution} F{args.features}"
                        f" h{args.hidden} zdiv{args.z_divisor}"))
        shape = (50, 50, 13, model.b_embedding.shape[0])
        axes = [torch.as_tensor(np.linspace(-1.0, 1.0, n), dtype=torch.float32, device=dev)
                for n in shape[:3]]

        def live(*_):
            return torch.as_tensor(infer_tensor_grid(model.params(), shape, clamp_min=0.0)
                                   ).reshape(*shape, -1)

        inputs, tol, what = axes, INR_TOL, f" vs live tensor-path inference {shape}"
    elif args.kind == "pia":
        model = PIA(number_of_signals=args.number_of_signals, device=dev)
        model.load_state_dict(_state_dict(args.params))
        model.requires_grad_(False)
        manifest = serve.export_pia(model, args.out, number_of_signals=args.number_of_signals,
                                    device=dev, model_desc=f"PIA S={args.number_of_signals}")
        sig = (torch.rand(129, args.number_of_signals, generator=gen) * 1000.0).to(dev)
        live, inputs, tol, what = model.encode, [sig], INR_TOL, ""
    else:
        # the serving build of misr_master: bf16 activations, the library convs
        model = load_model(RAMSConfig(filters=args.filters, N=args.N, channels=args.channels),
                           _rams_state_dict(args.params), dev)
        manifest = serve.export_rams(model, args.out, height=args.height, width=args.width,
                                     channels=args.channels, device=dev,
                                     model_desc=f"RAMS F={args.filters} N={args.N}")
        x = (torch.rand(2, args.height, args.width, args.channels, generator=gen)
             * 5000.0).to(dev)
        live, inputs, tol, what = model, [x], args.check_tol, ""
    print(f"exported {manifest['kind']} artifact -> {args.out} "
          f"(platforms {manifest['platforms']})")
    if args.check:
        manifest = dict(manifest, check_rel_err=_check(args.out, dev, live, inputs, tol, what))
    return manifest


if __name__ == "__main__":
    main()
