#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``mri_super_resolution_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--epochs 40] [--pn_epochs 4]

Phases, in order; any failure ends the run with a non-zero exit:
1. build: compile ``csrc/siren.cu`` with nvcc (sm_90a) and print the time
   and the compiler's register/spill report;
2. kernel parity: K1 ``siren_loss_grads``, K2 ``siren_fused_bwd`` (dx and
   dW) and K3 ``siren_forward`` against their plain PyTorch versions on the
   card at the flagship shapes (P = 70,000 rows, 256 -> 512x4 -> 1), K3
   also at the inference chunk (262,144 rows) and its ragged tails (71,424
   and 17,856 rows), and a small end-to-end patient on the card's kernels against the plain path on
   the CPU;
3. main path: ``pipelines.superres3d.run`` on a seeded (128, 128, 28)
   synthetic patient with 75 cross-b combinations at the ``reference``
   preset's full width (hidden 512, 3 hidden layers, 128 mappings, PN 128,
   ROI 40:90 -> 25x25x28x4 = 70,000 LR rows), epochs cut to ``--epochs``;
   checks the CSV and timings.json, finite and clamped outputs, a falling
   loss, and that K1, K2 and K3 each launched during this run;
4. times: each kernel at the main path's shapes with CUDA events, beside
   its plain version, the eager-autograd library equivalent and its bound.

The last three lines are the ``{"kernels": ...}`` record, the card's name
and power limit, and ``{"ok": true, "device": ...}``. Exits non-zero,
printing no result, when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12  # float32 FMA outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3

K3_TOL = 1e-4  # max |kernel - plain| / max |plain|, forward
K1_K2_TOL = 1e-3  # the same for the loss, dx and each dW/db (sums over P rows)
E2E_ATOL = 1e-3  # small patient: card kernels vs plain path on the CPU
INFER_CHUNK = 262_144  # rows per inference chunk (fit/engine.py:infer_dense_grid)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _rel(a, b) -> tuple[float, float]:
    err = float((a - b).abs().max())
    return err, err / max(float(b.abs().max()), 1e-30)


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _layer_macs(dims) -> list[int]:
    return [dims[i] * dims[i + 1] for i in range(len(dims) - 1)]


def _flagship_inputs(P: int, dims, seed: int):
    """Seeded numpy inputs at SIREN-init scale, moved to the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, size=(P, dims[0])).astype(np.float32)
    ws = []
    for l in range(len(dims) - 1):
        bound = 1.0 / dims[l] if l == 0 else np.sqrt(6.0 / dims[l]) / 30.0
        ws.append(rng.uniform(-bound, bound, size=(dims[l + 1], dims[l])))
        bb = 1.0 / np.sqrt(dims[l])
        ws.append(rng.uniform(-bb, bb, size=(dims[l + 1],)))
    target = rng.uniform(0.0, 1.0, size=(P, 1)).astype(np.float32)
    g = (rng.normal(size=(P, 1)) / P).astype(np.float32)
    cuda = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32)).cuda()
    return cuda(x), [cuda(w) for w in ws], cuda(target), cuda(g)


def phase_build() -> None:
    from mri_super_resolution_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(("siren",))
    print(f"[build] csrc/siren.cu built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.BUILD_SECONDS['siren']:.1f} s)")
    for line in _build.BUILD_LOG.get("siren", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def phase_parity(P: int, dims) -> dict:
    """Each kernel against its plain version on the card; returns max abs
    errors by kernel."""
    import torch

    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    x, ws, target, g = _flagship_inputs(P, dims, seed=0)
    errs = {}

    out = sk.siren_forward(x, ws)
    ref = sk.siren_forward_ref(x, ws)
    torch.cuda.synchronize()
    e, r = _rel(out, ref)
    print(f"[parity] K3 siren_forward  P={P}: max abs {e:.3e}, rel {r:.3e} "
          f"(tol rel {K3_TOL:g})")
    _require(r <= K3_TOL, "K3 disagrees with its plain version")
    # inference: full 262,144-row chunks and the ragged tails of the 2x grid
    # (1,120,000 rows) and the HR grid (280,000 rows)
    xc, wsc, _, _ = _flagship_inputs(INFER_CHUNK, dims, seed=2)
    for n in (INFER_CHUNK, 1_120_000 % INFER_CHUNK, 280_000 % INFER_CHUNK):
        ec, rc = _rel(sk.siren_forward(xc[:n], wsc), sk.siren_forward_ref(xc[:n], wsc))
        print(f"[parity] K3 siren_forward  P={n}: max abs {ec:.3e}, rel {rc:.3e} "
              f"(tol rel {K3_TOL:g})")
        _require(rc <= K3_TOL, f"K3 disagrees with its plain version at P={n}")
        e = max(e, ec)
    del xc, wsc
    errs["siren_forward"] = e

    loss, grads = sk.siren_loss_grads(x, ws, target)
    loss_r, grads_r = sk.siren_loss_grads_ref(x, ws, target)
    torch.cuda.synchronize()
    worst = _rel(loss, loss_r)
    for a, b in zip(grads, grads_r):
        worst = max(worst, _rel(a, b), key=lambda t: t[1])
    print(f"[parity] K1 siren_loss_grads: loss {float(loss):.6e} vs "
          f"{float(loss_r):.6e}; worst over loss/dW/db max abs {worst[0]:.3e}, "
          f"rel {worst[1]:.3e} (tol rel {K1_K2_TOL:g})")
    _require(worst[1] <= K1_K2_TOL, "K1 disagrees with its plain version")
    errs["siren_loss_grads"] = max(float((loss - loss_r).abs()),
                                   *[float((a - b).abs().max())
                                     for a, b in zip(grads, grads_r)])

    nr = P - 1234  # masked ragged rows
    loss_m, grads_m = sk.siren_loss_grads(x, ws, target, n_rows=nr)
    loss_mr, grads_mr = sk.siren_loss_grads_ref(x, ws, target, n_rows=nr)
    torch.cuda.synchronize()
    worst_m = _rel(loss_m, loss_mr)
    for a, b in zip(grads_m, grads_mr):
        worst_m = max(worst_m, _rel(a, b), key=lambda t: t[1])
    print(f"[parity] K1 n_rows={nr}: worst rel {worst_m[1]:.3e}")
    _require(worst_m[1] <= K1_K2_TOL, "K1 row mask disagrees")

    dx, dgr = sk.siren_fused_bwd(x, ws, g, need_dw=True)
    dx_r, dgr_r = sk.siren_fused_bwd_ref(x, ws, g)
    torch.cuda.synchronize()
    worst = _rel(dx, dx_r)
    for a, b in zip(dgr, dgr_r):
        worst = max(worst, _rel(a, b), key=lambda t: t[1])
    print(f"[parity] K2 siren_fused_bwd: dx max abs err {_rel(dx, dx_r)[0]:.3e} "
          f"(max |dx| {float(dx_r.abs().max()):.3e}); worst "
          f"over dx/dW/db max abs {worst[0]:.3e}, rel {worst[1]:.3e} "
          f"(tol rel {K1_K2_TOL:g})")
    _require(worst[1] <= K1_K2_TOL, "K2 disagrees with its plain version")
    dx_only, none = sk.siren_fused_bwd(x, ws, g, need_dw=False)
    _require(none is None and _rel(dx_only, dx_r)[1] <= K1_K2_TOL,
             "K2 without dW disagrees")
    errs["siren_fused_bwd"] = max(float((dx - dx_r).abs().max()),
                                  *[float((a - b).abs().max())
                                    for a, b in zip(dgr, dgr_r)])
    return errs


def phase_small_patient() -> None:
    """A tiny patient through the card's kernels vs the plain CPU path."""
    import numpy as np

    from mri_super_resolution_tpu_torch.config import SupperresDWIConfig
    from mri_super_resolution_tpu_torch.data import synthetic
    from mri_super_resolution_tpu_torch.pipelines import superres3d

    rng = np.random.default_rng(0)
    b0 = np.abs(rng.normal(1.0, 0.3, size=(24, 24, 3))).astype(np.float32)
    hybrid = synthetic.hybrid_from_b0(b0, acq_counts=(1, 2, 2, 2), seed=1)
    bv = np.asarray([0.0, 150.0, 1000.0, 1500.0])
    cfg = SupperresDWIConfig(number_of_epochs=30, perturbation_epochs=4,
                             hidden_dim=32, num_layers=1, pn_dim=16, roi_start=4,
                             roi_end=20, mapping_size=16)
    gpu = superres3d.run_patient(hybrid, bv, cfg, seed=0, device="cuda")
    cpu = superres3d.run_patient(hybrid, bv, cfg, seed=0, device="cpu")
    err = float(np.abs(gpu.recon_2x - cpu.recon_2x).max())
    loss_err = float(np.abs(gpu.losses - cpu.losses).max())
    print(f"[parity] small patient, card kernels vs CPU plain: recon max abs "
          f"{err:.3e}, loss trace max abs {loss_err:.3e} (tol {E2E_ATOL:g})")
    _require(err <= E2E_ATOL and loss_err <= E2E_ATOL, "small patient disagrees")


def phase_main_path(epochs: int, pn_epochs: int, out_dir: str):
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch.config import SupperresDWIConfig
    from mri_super_resolution_tpu_torch.data import synthetic
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk
    from mri_super_resolution_tpu_torch.pipelines import superres3d

    rng = np.random.default_rng(7)
    x, y, z = np.meshgrid(np.linspace(-1, 1, 128), np.linspace(-1, 1, 128),
                          np.linspace(-1, 1, 28), indexing="ij")
    b0 = (1000.0 * (np.exp(-(x ** 2 / 0.5 + y ** 2 / 0.3 + z ** 2))
                    + 0.05 * rng.random((128, 128, 28)))).astype(np.float32)
    t0 = time.perf_counter()
    hybrid = synthetic.hybrid_from_b0(b0, acq_counts=(1, 3, 5, 5), seed=7)
    bv = np.asarray([0.0, 150.0, 1000.0, 1500.0])
    print(f"[main] synthetic patient (128, 128, 28), acq (1, 3, 5, 5) in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = SupperresDWIConfig(number_of_epochs=epochs, perturbation_epochs=pn_epochs)

    results = []
    run_patient = superres3d.run_patient

    def recording(*args, **kwargs):
        r = run_patient(*args, **kwargs)
        results.append(r)
        return r

    superres3d.run_patient = recording  # keep the result for the checks below
    try:
        sk.reset_launches()
        t0 = time.perf_counter()
        superres3d.run([(0, hybrid, bv)], cfg, out_dir, seed=0, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(sk.LAUNCHES)
    finally:
        superres3d.run_patient = run_patient

    (res,) = results
    csv_path = os.path.join(out_dir, "pat0", "ssim_scores.csv")
    timings_path = os.path.join(out_dir, "timings.json")
    _require(os.path.isfile(csv_path) and os.path.isfile(timings_path),
             "run() wrote no CSV or timings.json")
    lines = open(csv_path).read().splitlines()
    _require(lines[0].startswith("Pt_id") and len(lines) == 1 + 28 * 4,
             f"CSV has {len(lines)} lines")
    ssim = np.asarray([r[3:] for r in res.ssim_rows], dtype=np.float64)
    _require(np.isfinite(ssim).all() and (np.abs(ssim) <= 1.0).all(), "SSIM rows")
    _require(res.recon_2x.shape == (100, 100, 28, 4), "recon_2x shape")
    _require(res.sr_hr_grid.shape == (50, 50, 28, 4), "sr_hr_grid shape")
    _require(np.isfinite(res.recon_2x).all() and (res.recon_2x >= 0).all(),
             "recon_2x finite and >= 0")
    _require(np.isfinite(res.sr_hr_grid).all() and (res.sr_hr_grid >= 0).all(),
             "sr_hr_grid finite and >= 0")
    n1 = epochs - pn_epochs
    _require(np.isfinite(res.losses).all() and res.losses[n1 - 1] < res.losses[0],
             f"mean-fit loss did not fall: {res.losses[0]} -> {res.losses[n1 - 1]}")
    for name, n in launches.items():
        _require(n > 0, f"kernel {name} was not launched on the main path")
    timings = json.load(open(timings_path))
    _require(timings["platform"] == "cuda", "timings.json platform")
    print(f"[main] run() {wall:.1f} s; launches {launches}; loss "
          f"{res.losses[0]:.4e} -> {res.losses[n1 - 1]:.4e}; mean SSIM spline "
          f"{ssim[:, 0].mean():.4f}, SR {ssim[:, 1].mean():.4f}")
    print(f"[main] phases {json.dumps(timings['patients'][0])}")
    return launches


def phase_times(P: int, dims, errs: dict, launches: dict) -> list[dict]:
    import torch

    from mri_super_resolution_tpu_torch.models import Siren
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    x, ws, target, g = _flagship_inputs(P, dims, seed=1)
    n_sine = len(dims) - 2
    module = Siren(dims[0], dims[1], n_sine - 1, device="cuda")
    with torch.no_grad():
        for p, w in zip(module.weights(), ws):
            p.copy_(w)
    params = module.weights()

    def lib_forward():
        with torch.no_grad():
            module(x)

    def lib_loss_grads():
        loss = torch.mean((module(x) - target) ** 2)
        torch.autograd.grad(loss, params)

    module_frozen = Siren(dims[0], dims[1], n_sine - 1, device="cuda")
    module_frozen.load_state_dict(module.state_dict())
    module_frozen.requires_grad_(False)
    xr = x.clone().requires_grad_()

    def lib_fused_bwd():
        torch.autograd.grad(module_frozen(xr), xr, g)

    macs = _layer_macs(dims)
    fwd, chain = sum(macs), sum(macs[1:])
    weight_bytes = 4 * sum(w.numel() for w in ws)
    in_bytes = 4 * x.numel()
    specs = [
        ("siren_forward", ":240", lambda: sk.siren_forward(x, ws),
         lambda: sk.siren_forward_ref(x, ws), lib_forward,
         2 * P * fwd, in_bytes + weight_bytes + 4 * P),
        ("siren_loss_grads", ":518", lambda: sk.siren_loss_grads(x, ws, target),
         lambda: sk.siren_loss_grads_ref(x, ws, target), lib_loss_grads,
         2 * P * (2 * fwd + chain), in_bytes + 2 * weight_bytes + 4 * P + 4),
        # as the main path calls it: dx for the PerturbNet step, no dW
        ("siren_fused_bwd", ":377",
         lambda: sk.siren_fused_bwd(x, ws, g, need_dw=False),
         lambda: sk.siren_fused_bwd_ref(x, ws, g, need_dw=False), lib_fused_bwd,
         2 * P * (sum(macs[:-1]) + chain + macs[0]),
         2 * in_bytes + weight_bytes + 4 * P),
    ]
    rows = []
    for name, line, kern, plain, lib, flops, nbytes in specs:
        ms = _time_ms(kern, 10)
        plain_ms = _time_ms(plain, 10)
        lib_ms = _time_ms(lib, 10)
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "mri_super_resolution_tpu_torch/csrc/siren.cu",
            "replaces": f"mri_super_resolution_tpu/ops/pallas/siren_kernel.py{line}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms,
        })
        print(f"[times] {name} P={P}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"library {lib_ms:.3f} ms, bound {max(t_ops, t_bytes):.3f} ms "
              f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB) -> "
              f"{flops / ms / 1e9:.2f} TFLOP/s")
    xc, wsc, _, _ = _flagship_inputs(INFER_CHUNK, dims, seed=2)
    ms_chunk = _time_ms(lambda: sk.siren_forward(xc, wsc), 5)
    print(f"[times] siren_forward at the inference chunk P={INFER_CHUNK}: "
          f"{ms_chunk:.3f} ms")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--pn_epochs", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    from mri_super_resolution_tpu_torch import set_float32_precision

    set_float32_precision()
    t_start = time.perf_counter()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    P, dims = 70_000, (256, 512, 512, 512, 512, 1)
    phase_build()
    errs = phase_parity(P, dims)
    phase_small_patient()
    with tempfile.TemporaryDirectory() as out_dir:
        launches = phase_main_path(args.epochs, args.pn_epochs, out_dir)
    rows = phase_times(P, dims, errs, launches)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
