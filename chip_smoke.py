#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``mri_super_resolution_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--epochs 40] [--pn_epochs 4]

Phases, in order; any failure ends the run with a non-zero exit:
1. build: compile ``csrc/siren.cu``, ``csrc/wire.cu`` and ``csrc/conv3d.cu``
   with nvcc (sm_90a), one process each, started together, and print the
   times and the compiler's register/spill report;
2. kernel parity against the plain PyTorch versions on the card: K1
   ``siren_loss_grads``, K2 ``siren_fused_bwd`` (dx and dW) and K3
   ``siren_forward`` at the SIREN flagship (P = 70,000 rows, 256 -> 512x4
   -> 1), K3 also at the inference chunk (262,144 rows) and its ragged tails
   (71,424 and 17,856 rows); K5 ``wire_forward`` and K4 ``wire_loss_grads``
   at the WIRE path's 4 -> 256x2 -> 1 and at 512x2, on 70,000 rows, the
   chunk and its tails (K5) and with 1234 masked rows (K4); K6
   ``conv3d_rfab`` at the seven shapes of the MISR path in bf16 and float32
   and on ragged shapes; then a small SIREN and a small WIRE patient and a
   small RAMS forward on the card's kernels against the plain path on the
   CPU;
3. main paths: ``pipelines.superres3d.run`` on a seeded (128, 128, 28)
   synthetic patient with 75 cross-b combinations, ROI 40:90 -> 25x25x28x4
   = 70,000 LR rows, once at the ``reference`` preset (SIREN 512x3, 128
   mappings, PN 128) and once with ``inr_model="wire"`` at the JAX package's
   WIRE defaults (256x2, omega = sigma = 10, raw coordinates), each with the
   epochs cut to ``--epochs`` and ``--pn_epochs``; checks the
   CSV and timings.json, finite and clamped outputs, a falling loss, and,
   with every launch count set to 0 just before each run, that each kernel
   of the path launched exactly as often as the schedule says (K1 and K4 on
   every mean step, K3 on every inference chunk and PN step, K5 on every
   inference chunk) and no other kernel did; then ``pipelines.misr.run`` on
   two seeded synthetic cases (b0 (128, 128, 24), 27 acquisitions, 25
   draws) with the committed RAMS checkpoint at full width in bf16 with
   ``conv_kernel=True``: DICOMs, timings.json, finite (384, 384) outputs in
   [0, 65536], and exactly 34 K6 launches per case and no other kernel;
   the same cases on the library route and in float32 bound the route gap;
4. times: each kernel at its main path's shapes with CUDA events, beside
   its plain version, the library equivalent (eager autograd; ``F.conv3d``
   for K6) and its bound; the 25-draw RAMS forward on both routes.

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
PEAK_BF16_TC = 989e12  # bf16 dense tensor cores
PEAK_BYTES = 3.35e12  # HBM3

SOURCES = ("siren", "wire", "conv3d")  # csrc/<name>.cu
K3_TOL = 1e-4  # max |kernel - plain| / max |plain|, forward
K1_K2_TOL = 1e-3  # the same for the loss, dx and each dW/db (sums over P rows)
K5_TOL = 1e-4  # WIRE forward, as K3
K4_TOL = 1e-3  # WIRE loss and every dW, as K1
E2E_ATOL = 1e-3  # small patient: card kernels vs plain path on the CPU
# K6 float32: max |kernel - plain| / max |plain|; the two sum 27 C products
# in other orders (the K1 class)
K6_F32_TOL = 1e-5
# K6 bf16: one bf16 ulp of each output (the float32 sums may round apart),
# plus the float32 order term above
K6_BF16_ULPS = 1
# the MISR path's K6 shapes: (input shape, padding, launches per forward);
# 25 draws of a 128 x 128 slice, reflect-padded to 130, then 132 before
# each temporal step (T 9 -> 7 -> 5 -> 3)
K6_SHAPES = (
    ((25, 130, 130, 9, 32), "SAME", 25),
    ((25, 132, 132, 9, 32), "SAME", 2),
    ((25, 132, 132, 7, 32), "SAME", 2),
    ((25, 132, 132, 5, 32), "SAME", 2),
    ((25, 132, 132, 9, 32), "VALID", 1),
    ((25, 132, 132, 7, 32), "VALID", 1),
    ((25, 132, 132, 5, 32), "VALID", 1),
)
K6_PER_FORWARD = sum(n for _, _, n in K6_SHAPES)  # 2 N + 1 + 3 (T // 3) = 34
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
    _build.build(SOURCES)  # one nvcc per source, all started together
    print(f"[build] csrc/{{{','.join(SOURCES)}}}.cu built in "
          f"{time.perf_counter() - t0:.1f} s (nvcc "
          + ", ".join(f"{s} {_build.BUILD_SECONDS[s]:.1f} s" for s in SOURCES) + ")")
    for name in SOURCES:
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def _wire_inputs(P: int, H: int, n_hidden: int, seed: int):
    """A seeded ``Wire`` at its init (omega = sigma = 10) on the card, raw
    4-D coordinates in [-1, 1] and a target in [0, 1]."""
    import torch

    from mri_super_resolution_tpu_torch.models import Wire

    gen = torch.Generator().manual_seed(seed)
    model = Wire(4, H, n_hidden, generator=gen).cuda()
    model.requires_grad_(False)
    x = (torch.rand(P, 4, generator=gen) * 2.0 - 1.0).cuda()
    target = torch.rand(P, 1, generator=gen).cuda()
    return model, x, target


def _worst_rel(pairs) -> tuple[float, float]:
    """(max abs error, worst relative error) over (kernel, plain) pairs,
    each relative to its plain tensor's largest magnitude."""
    errs = [_rel(a, b) for a, b in pairs]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def phase_wire_parity(P: int) -> dict:
    """K5 and K4 against their plain versions on the card: at the main
    path's 4 -> 256x2 -> 1 on P rows (K4 also with masked rows), K5 at the
    inference chunk and the ragged tails of the main path, and both at the
    512x2 width; returns max abs errors by kernel."""
    import torch

    from mri_super_resolution_tpu_torch.ops import wire_kernel as wk

    errs = {"wire_forward": 0.0, "wire_loss_grads": 0.0}
    for H in (256, 512):
        model, x, target = _wire_inputs(P, H, 2, seed=H)
        ws, _, oms = wk.split_params(model.params(), 2)
        gen = torch.Generator().manual_seed(H + 1)
        for n in (P, INFER_CHUNK, 1_120_000 % INFER_CHUNK, 280_000 % INFER_CHUNK):
            xn = x if n == P else (torch.rand(n, 4, generator=gen) * 2.0 - 1.0).cuda()
            e, r = _rel(wk.wire_forward(xn, ws, oms), wk.wire_forward_ref(xn, ws, oms))
            print(f"[parity] K5 wire_forward H={H} P={n}: max abs {e:.3e}, rel {r:.3e} "
                  f"(tol rel {K5_TOL:g})")
            _require(r <= K5_TOL, f"K5 disagrees with its plain version (H={H}, P={n})")
            errs["wire_forward"] = max(errs["wire_forward"], e)
        for n_rows in (P, P - 1234):
            loss, grads = wk.wire_loss_grads(x, ws, oms, target, n_rows=n_rows)
            loss_r, grads_r = wk.wire_loss_grads_ref(x, ws, oms, target, n_rows=n_rows)
            torch.cuda.synchronize()
            e, r = _worst_rel([(loss, loss_r), *zip(grads, grads_r)])
            print(f"[parity] K4 wire_loss_grads H={H} n_rows={n_rows}: loss "
                  f"{float(loss):.6e} vs {float(loss_r):.6e}; worst over loss/dW max "
                  f"abs {e:.3e}, rel {r:.3e} (tol rel {K4_TOL:g})")
            _require(r <= K4_TOL, f"K4 disagrees with its plain version (H={H})")
            errs["wire_loss_grads"] = max(errs["wire_loss_grads"], e)
        del model, x, target
    return errs


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


def phase_small_patient(inr_model: str) -> None:
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
                             roi_end=20, mapping_size=16, inr_model=inr_model,
                             wire_hidden=32, wire_layers=2)
    gpu = superres3d.run_patient(hybrid, bv, cfg, seed=0, device="cuda")
    cpu = superres3d.run_patient(hybrid, bv, cfg, seed=0, device="cpu")
    err = float(np.abs(gpu.recon_2x - cpu.recon_2x).max())
    loss_err = float(np.abs(gpu.losses - cpu.losses).max())
    print(f"[parity] small {inr_model} patient, card kernels vs CPU plain: recon "
          f"max abs {err:.3e}, loss trace max abs {loss_err:.3e} (tol {E2E_ATOL:g})")
    _require(err <= E2E_ATOL and loss_err <= E2E_ATOL,
             f"small {inr_model} patient disagrees")


def _k6_inputs(shape, dtype, seed: int):
    """Seeded activations and a kernel at the scale of the committed RAMS's
    folded weights (|w| about 0.05), bias in float32, on the card."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    C = shape[-1]
    x = torch.randn(shape, generator=gen).to("cuda", dtype)
    w = (torch.randn((3, 3, 3, C, C), generator=gen) * 0.05).cuda()
    b = (torch.randn((C,), generator=gen) * 0.1).cuda()
    return x, w, b


def _k6_check(out, ref, what: str) -> float:
    """Hold K6 against its plain version: float32 within K6_F32_TOL of the
    largest output; bf16 within K6_BF16_ULPS bf16 ulps of each output plus
    the float32 order term. Returns the max abs error."""
    import torch

    diff = (out.float() - ref.float()).abs()
    scale = float(ref.float().abs().max())
    err = float(diff.max())
    if out.dtype == torch.float32:
        ok = err <= K6_F32_TOL * scale
        tol = f"rel {K6_F32_TOL:g}"
    else:
        ulp = 2.0 ** (torch.floor(torch.log2(ref.float().abs().clamp_min(1e-30))) - 7)
        ok = bool((diff <= K6_BF16_ULPS * ulp + K6_F32_TOL * scale).all())
        tol = f"{K6_BF16_ULPS} bf16 ulp"
    print(f"[parity] K6 conv3d_rfab {what}: max abs {err:.3e}, max |plain| {scale:.3e} "
          f"(tol {tol})")
    _require(ok, f"K6 disagrees with its plain version ({what})")
    return err


def phase_k6_parity() -> float:
    """K6 against its plain version at the seven MISR path shapes in bf16
    and float32, and on ragged shapes (B 1, H != W, odd sizes, C 8 and 16,
    SAME and VALID); returns the max abs error over the path's bf16 calls."""
    import torch

    from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck

    err = 0.0
    with torch.no_grad():
        for i, (shape, pad, _) in enumerate(K6_SHAPES):
            for dtype in (torch.bfloat16, torch.float32):
                x, w, b = _k6_inputs(shape, dtype, seed=i)
                e = _k6_check(ck.conv3d_rfab(x, w, b, pad), ck.conv3d_rfab_ref(x, w, b, pad),
                              f"{shape} {pad} {str(dtype)[6:]}")
                if dtype == torch.bfloat16:
                    err = max(err, e)
                del x
        for shape, pad in (((1, 37, 21, 5, 8), "SAME"), ((1, 19, 45, 7, 16), "VALID"),
                           ((1, 3, 5, 3, 16), "VALID")):
            for dtype in (torch.bfloat16, torch.float32):
                x, w, b = _k6_inputs(shape, dtype, seed=sum(shape))
                _k6_check(ck.conv3d_rfab(x, w, b, pad), ck.conv3d_rfab_ref(x, w, b, pad),
                          f"{shape} {pad} {str(dtype)[6:]}")
    torch.cuda.empty_cache()
    return err


def _misr_case(seed: int, side: int = 128, slices: int = 24):
    """A seeded synthetic case: b0 (side, side, slices) at DWI magnitudes
    (a smooth blob of about 100 on a floor of 90: after the b = 900 decay
    and x256 the slice's mean lands near the PROBA-V mean of 7433), 27
    acquisitions (9, 9, 9) from ``acquisitions_from_b0``, cancer slice 12."""
    import numpy as np

    from mri_super_resolution_tpu_torch.data import Case, synthetic

    rng = np.random.default_rng(seed)
    x, y, z = np.meshgrid(np.linspace(-1, 1, side), np.linspace(-1, 1, side),
                          np.linspace(-1, 1, slices), indexing="ij")
    b0 = (100.0 * np.exp(-(x ** 2 / 0.5 + y ** 2 / 0.3 + z ** 2)) + 90.0
          + 5.0 * rng.random((side, side, slices))).astype(np.float32)
    dwi = synthetic.acquisitions_from_b0(b0, num_acq=27, b=900.0, seed=seed)
    return Case(pt_id=f"synth-{seed:02d}", b=900.0, cancer_loc=(side // 2, side // 2),
                contralateral_loc=(side // 4, side // 2), noise=(2, 2), cancer_slice=12,
                acquisitions=(9, 9, 9), dwi=dwi, b0=b0, erd=np.ones_like(b0),
                accept=np.ones(dwi.shape, dtype=np.int32), synthetic_dwi=True)


def phase_small_misr() -> None:
    """A small float32 RAMS (filters 8, N 1) with conv_kernel: the 25-draw
    stack of a small case through K6 on the card against the plain path on
    the CPU, within the RAMS class of the JAX package (rtol 2e-5, atol
    2e-2)."""
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch.config import RAMSConfig
    from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck
    from mri_super_resolution_tpu_torch.pipelines import misr

    cfg = RAMSConfig(filters=8, N=1, compute_dtype="float32", conv_kernel=True)
    model = misr.build_rams(cfg, generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    case = _misr_case(seed=1, side=24, slices=13)
    lor = case.dwi[:, :, 12, :9].astype(np.float32) * 256.0
    x = torch.as_tensor(np.stack([lor, lor[..., ::-1]]))
    with torch.inference_mode():
        cpu = model(x)
        ck.reset_launches()
        gpu = model.cuda()(x.cuda()).cpu()
    err = float((gpu - cpu).abs().max())
    print(f"[parity] small RAMS (8, 1) forward, card K6 vs CPU plain: max abs {err:.3e} "
          f"of {float(cpu.abs().max()):.1f} (tol rtol 2e-5, atol 2e-2); K6 launches "
          f"{ck.LAUNCHES['conv3d_rfab']}")
    _require(bool(torch.allclose(gpu, cpu, rtol=2e-5, atol=2e-2)),
             "small RAMS disagrees between the card and the CPU")
    _require(ck.LAUNCHES["conv3d_rfab"] == 2 * 1 + 1 + 3 * 3, "small RAMS K6 launches")


def _run_misr(cases, cfg, state_dict, out_dir: str):
    """misr.run() with each case's outputs and K6 launches recorded; every
    launch count is set to 0 just before the run and read just after."""
    import torch

    from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk
    from mri_super_resolution_tpu_torch.ops import wire_kernel as wk
    from mri_super_resolution_tpu_torch.pipelines import misr

    per_case = []
    predict_case = misr.predict_case

    def recording(*args, **kwargs):
        before = ck.LAUNCHES["conv3d_rfab"]
        out = predict_case(*args, **kwargs)
        per_case.append((out, ck.LAUNCHES["conv3d_rfab"] - before))
        return out

    misr.predict_case = recording
    try:
        for mod in (sk, wk, ck):
            mod.reset_launches()
        t0 = time.perf_counter()
        misr.run(cases, cfg, state_dict, out_dir, exp_name="smoke", sample_size=25, seed=0,
                 device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**sk.LAUNCHES, **wk.LAUNCHES, **ck.LAUNCHES}
    finally:
        misr.predict_case = predict_case
    return per_case, launches, wall


def phase_misr_main(out_dir: str) -> dict:
    """The MISR serving path: misr.run() on two full-width synthetic cases
    with the committed checkpoint, bf16, conv_kernel=True, 25 draws. Then
    the same cases on the library route (cuDNN everywhere) and in float32:
    the two bf16 routes may differ by at most twice the library route's own
    bf16-vs-float32 gap (on the CPU, tests/test_torch_rams.py: 0.61 of it,
    73.5 vs 121, for the committed RAMS on a (2, 16, 16, 9) input). Returns
    the path's launches."""
    import dataclasses

    import numpy as np

    from mri_super_resolution_tpu_torch import convert
    from mri_super_resolution_tpu_torch.config import RAMSConfig

    t0 = time.perf_counter()
    cases = [_misr_case(seed) for seed in (11, 12)]
    print(f"[main misr] two synthetic cases, b0 (128, 128, 24), 27 acquisitions, in "
          f"{time.perf_counter() - t0:.1f} s")
    sd = convert.rams_state_dict(convert.load_params_npz(convert.RAMS_PARAMS_NPZ))
    cfg = RAMSConfig(conv_kernel=True)
    per_case, launches, wall = _run_misr(cases, cfg, sd, out_dir)
    for case, ((mean_pred, adc), n) in zip(cases, per_case):
        base = os.path.join(out_dir, "smoke", case.pt_no)
        _require(all(os.path.isfile(os.path.join(base, k, "mean.dcm")) for k in ("DWI", "ADC")),
                 f"no DICOMs for case {case.pt_no}")
        _require(mean_pred.shape == adc.shape == (384, 384), "MISR output shape")
        _require(bool(np.isfinite(mean_pred).all() and mean_pred.min() >= 0
                      and mean_pred.max() <= 65536), "mean_pred finite and in [0, 65536]")
        _require(bool(np.isfinite(adc).all()), "ADC finite")
        _require(n == K6_PER_FORWARD, f"K6 launched {n} times for case {case.pt_no}, "
                 f"expected {K6_PER_FORWARD}")
    for name, n in launches.items():
        want = K6_PER_FORWARD * len(cases) if name == "conv3d_rfab" else 0
        _require(n == want, f"{name} launched {n} times on the MISR path, expected {want}")
    timings = json.load(open(os.path.join(out_dir, "smoke", "timings.json")))
    _require(timings["platform"] == "cuda", "timings.json platform")
    predict_s = [c["predict_s"] for c in timings["cases"]]
    print(f"[main misr] run() {wall:.2f} s; launches {launches}; predict_s "
          f"{', '.join(f'{t:.3f}' for t in predict_s)}; mean_pred range "
          f"[{per_case[1][0][0].min():.0f}, {per_case[1][0][0].max():.0f}]")

    route = {}
    for name, c in (("library", dataclasses.replace(cfg, conv_kernel=False)),
                    ("float32", dataclasses.replace(cfg, conv_kernel=False,
                                                    compute_dtype="float32"))):
        pc, _, _ = _run_misr(cases, c, sd, os.path.join(out_dir, name))
        route[name] = [out[0] for out, _ in pc]
    k6 = [out[0] for out, _ in per_case]
    gap = max(float(np.abs(a - b).max()) for a, b in zip(k6, route["library"]))
    own = max(float(np.abs(a - b).max()) for a, b in zip(route["library"], route["float32"]))
    print(f"[main misr] mean_pred, K6 route vs library route: max abs {gap:.2f}; library "
          f"bf16 vs float32: {own:.2f} (tol: route gap <= 2x that)")
    _require(gap <= 2 * own, "the K6 and library routes differ beyond the bf16 bound")
    return {"conv3d_rfab": launches["conv3d_rfab"]}


def phase_k6_times(err: float, launches: dict) -> dict:
    """K6 in bf16 at each MISR path shape: the kernel, its plain version and
    ``F.conv3d`` on the same channels-last tensors (bias in bf16), with CUDA
    events, beside the bound; the kernels-line row is the SAME shape that
    runs 25 of the 34 launches."""
    import torch
    import torch.nn.functional as F

    from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck

    row = None
    per_forward = {"kernel": 0.0, "library": 0.0}
    with torch.no_grad():
        for i, (shape, pad, n) in enumerate(K6_SHAPES):
            x, w, b = _k6_inputs(shape, torch.bfloat16, seed=i)
            wb, bb = w.bfloat16(), b.bfloat16()
            xt = x.permute(0, 4, 1, 2, 3)  # channels-last 3-D, no copy
            wt = wb.permute(4, 3, 0, 1, 2).contiguous()
            B, Ho, Wo, To = ck.out_shape(shape, pad)
            C = shape[-1]
            flops = 2 * B * Ho * Wo * To * C * 27 * C
            nbytes = 2 * x.numel() + 2 * wb.numel() + 4 * b.numel() + 2 * B * Ho * Wo * To * C
            r = _time_row("conv3d_rfab", "conv3d", "conv3d_kernel.py:109",
                          lambda: ck.conv3d_rfab(x, w, b, pad),
                          lambda: ck.conv3d_rfab_ref(x, w, b, pad),
                          lambda: F.conv3d(xt, wt, bb, padding=pad.lower()),
                          flops, nbytes, f"{shape} {pad}", {"conv3d_rfab": err}, launches,
                          peak=PEAK_BF16_TC, reps=5)
            per_forward["kernel"] += n * r["ms"]
            per_forward["library"] += n * r["library_ms"]
            if row is None:
                row = r
            del x, xt
        torch.cuda.empty_cache()
    print(f"[times] K6 per RAMS forward (34 launches): kernel {per_forward['kernel']:.2f} ms, "
          f"F.conv3d {per_forward['library']:.2f} ms")
    return row


def phase_rams_forward_times() -> None:
    """The 25-draw RAMS forward at full width on a (25, 128, 128, 9) stack,
    bf16, with conv_kernel on and off (host clock around the synchronised
    forward, best of 3)."""
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch import convert
    from mri_super_resolution_tpu_torch.config import RAMSConfig
    from mri_super_resolution_tpu_torch.models.rams import fold_weight_norm
    from mri_super_resolution_tpu_torch.pipelines import misr

    sd = fold_weight_norm(convert.rams_state_dict(
        convert.load_params_npz(convert.RAMS_PARAMS_NPZ)))
    case = _misr_case(seed=11)
    lor = case.dwi[:, :, 12, :9].astype(np.float32) * 256.0
    x = torch.as_tensor(np.repeat(lor[None], 25, axis=0)).cuda()
    models = {}
    for conv_kernel in (True, False):
        models[conv_kernel] = misr.build_rams(RAMSConfig(conv_kernel=conv_kernel),
                                              device="cuda")
        models[conv_kernel].load_state_dict(sd)
        models[conv_kernel].requires_grad_(False)
    for conv_kernel in (True, False, True, False):
        model = models[conv_kernel]
        best = float("inf")
        with torch.inference_mode():
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model(x)
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
        print(f"[times] RAMS 25-draw forward, conv_kernel={conv_kernel}: {1e3 * best:.1f} ms")


def _expected_launches(inr_model: str, epochs: int, pn_epochs: int) -> dict:
    """Launches of each kernel of the path in one patient: every mean step
    (the first epochs - pn_epochs and the odd alternating epochs) is one
    K1/K4; each even alternating epoch is one PN step per combination (75),
    a K3 forward and a K2 backward on the SIREN path; inference is 5 + 2
    chunks (1,120,000 and 280,000 rows at 262,144 a chunk)."""
    n1 = epochs - pn_epochs
    odd = sum(e % 2 for e in range(n1, epochs))
    pn_steps = 75 * (pn_epochs - odd)
    if inr_model == "wire":
        return {"wire_loss_grads": n1 + odd, "wire_forward": 7}
    return {"siren_loss_grads": n1 + odd, "siren_fused_bwd": pn_steps,
            "siren_forward": pn_steps + 7}


def phase_main_path(inr_model: str, epochs: int, pn_epochs: int, out_dir: str):
    """The pipeline's run() on a full-width synthetic patient; returns the
    launches of this path's kernels, counted from 0 over this run only."""
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch.config import SupperresDWIConfig
    from mri_super_resolution_tpu_torch.data import synthetic
    from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk
    from mri_super_resolution_tpu_torch.ops import wire_kernel as wk
    from mri_super_resolution_tpu_torch.pipelines import superres3d

    rng = np.random.default_rng(7)
    x, y, z = np.meshgrid(np.linspace(-1, 1, 128), np.linspace(-1, 1, 128),
                          np.linspace(-1, 1, 28), indexing="ij")
    b0 = (1000.0 * (np.exp(-(x ** 2 / 0.5 + y ** 2 / 0.3 + z ** 2))
                    + 0.05 * rng.random((128, 128, 28)))).astype(np.float32)
    t0 = time.perf_counter()
    hybrid = synthetic.hybrid_from_b0(b0, acq_counts=(1, 3, 5, 5), seed=7)
    bv = np.asarray([0.0, 150.0, 1000.0, 1500.0])
    print(f"[main {inr_model}] synthetic patient (128, 128, 28), acq (1, 3, 5, 5) "
          f"in {time.perf_counter() - t0:.1f} s")
    cfg = SupperresDWIConfig(number_of_epochs=epochs, perturbation_epochs=pn_epochs,
                             inr_model=inr_model)

    results = []
    run_patient = superres3d.run_patient

    def recording(*args, **kwargs):
        r = run_patient(*args, **kwargs)
        results.append(r)
        return r

    superres3d.run_patient = recording  # keep the result for the checks below
    try:
        for mod in (sk, wk, ck):
            mod.reset_launches()
        t0 = time.perf_counter()
        superres3d.run([(0, hybrid, bv)], cfg, out_dir, seed=0, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**sk.LAUNCHES, **wk.LAUNCHES, **ck.LAUNCHES}
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
    want = _expected_launches(inr_model, epochs, pn_epochs)
    for name, n in launches.items():
        _require(n == want.get(name, 0),
                 f"{name} launched {n} times on the {inr_model} path, expected "
                 f"{want.get(name, 0)}")
    for name in want:
        _require(launches[name] > 0, f"kernel {name} was not launched on the main path")
    timings = json.load(open(timings_path))
    _require(timings["platform"] == "cuda", "timings.json platform")
    print(f"[main {inr_model}] run() {wall:.1f} s; launches {launches}; loss "
          f"{res.losses[0]:.4e} -> {res.losses[n1 - 1]:.4e}; mean SSIM spline "
          f"{ssim[:, 0].mean():.4f}, SR {ssim[:, 1].mean():.4f}")
    print(f"[main {inr_model}] phases {json.dumps(timings['patients'][0])}")
    return {name: launches[name] for name in want}


def _time_row(name, source, replaces, kern, plain, lib, flops, nbytes, at, errs,
              launches, peak=PEAK_F32_FLOPS, reps=10) -> dict:
    """One entry of the kernels line: the kernel, its plain version and the
    library call timed with CUDA events, beside the bound of the work at
    ``peak`` operations per second."""
    ms = _time_ms(kern, reps)
    plain_ms = _time_ms(plain, reps)
    lib_ms = _time_ms(lib, reps)
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    print(f"[times] {name} {at}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"library {lib_ms:.3f} ms, bound {max(t_ops, t_bytes):.3f} ms "
          f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB) -> "
          f"{flops / ms / 1e9:.2f} TFLOP/s")
    return {
        "name": name, "route": "cuda",
        "source": f"mri_super_resolution_tpu_torch/csrc/{source}.cu",
        "replaces": f"mri_super_resolution_tpu/ops/pallas/{replaces}",
        "launches": launches[name], "max_abs_err": errs[name],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib_ms,
    }


def _wire_macs(d: int, H: int, nh: int) -> tuple[int, int, int]:
    """Multiply-adds per row of the WIRE products: forward (first layer
    [W; Wo], nh block GEMMs of 2H x 4H, final 2H), the weight gradients
    (the same shapes) and the upstream gradients (nh block GEMMs and the
    final layer's 2H; none for the coordinates)."""
    fwd = 2 * H * d + nh * 8 * H * H + 2 * H
    return fwd, fwd, nh * 8 * H * H + 2 * H


def phase_wire_times(P: int, errs: dict, launches: dict) -> list[dict]:
    """K4 at the main path's P rows and K5 at its 262,144-row inference
    chunk (4 -> 256x2 -> 1), beside eager autograd of the Wire module; K4
    at 512x2 and K5 at P rows printed for the record."""
    import torch

    from mri_super_resolution_tpu_torch.ops import wire_kernel as wk

    rows = []
    for H, record in ((256, True), (512, False)):
        model, x, target = _wire_inputs(P, H, 2, seed=H)
        ws, _, oms = wk.split_params(model.params(), 2)
        fwd, dw, dh = _wire_macs(4, H, 2)
        wbytes = 4 * sum(w.numel() for w in ws) + 4 * oms.numel()
        for w in ws:
            w.requires_grad_(True)

        def lib_loss_grads():
            loss = torch.mean((model(x) - target) ** 2)
            torch.autograd.grad(loss, ws)

        row = _time_row(
            "wire_loss_grads", "wire", "wire_kernel.py:302",
            lambda: wk.wire_loss_grads(x, ws, oms, target),
            lambda: wk.wire_loss_grads_ref(x, ws, oms, target), lib_loss_grads,
            2 * P * (fwd + dw + dh), 4 * x.numel() + 4 * P + 2 * wbytes + 4, f"P={P}", errs,
            launches)
        gen = torch.Generator().manual_seed(H + 2)
        xc = (torch.rand(INFER_CHUNK, 4, generator=gen) * 2.0 - 1.0).cuda()
        for n, xn in ((P, x), (INFER_CHUNK, xc)):
            @torch.no_grad()
            def plain_forward(xn=xn):
                wk.wire_forward_ref(xn, ws, oms)

            @torch.no_grad()
            def lib_forward(xn=xn):
                model(xn)

            frow = _time_row(
                "wire_forward", "wire", "wire_kernel.py:146",
                lambda xn=xn: wk.wire_forward(xn, ws, oms), plain_forward, lib_forward,
                2 * n * fwd, 4 * xn.numel() + wbytes + 4 * n, f"P={n}", errs, launches)
        if record:
            rows += [row, frow]  # K5 at the inference chunk, as the path runs it
        print(f"[times] the rows above: width {H}x2")
        del model, x, target, ws, xc
        torch.cuda.empty_cache()
    return rows


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
    rows = [_time_row(name, "siren", f"siren_kernel.py{line}", kern, plain, lib, flops,
                      nbytes, f"P={P}", errs, launches)
            for name, line, kern, plain, lib, flops, nbytes in specs]
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
    errs.update(phase_wire_parity(P))
    k6_err = phase_k6_parity()
    for inr_model in ("siren", "wire"):
        phase_small_patient(inr_model)
    phase_small_misr()
    launches = {}
    for inr_model in ("siren", "wire"):
        with tempfile.TemporaryDirectory() as out_dir:
            launches.update(phase_main_path(inr_model, args.epochs, args.pn_epochs,
                                            out_dir))
    with tempfile.TemporaryDirectory() as out_dir:
        launches.update(phase_misr_main(out_dir))
    rows = phase_times(P, dims, errs, launches) + phase_wire_times(P, errs, launches)
    rows.append(phase_k6_times(k6_err, launches))
    phase_rams_forward_times()
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
