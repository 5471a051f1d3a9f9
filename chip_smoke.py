#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``mri_super_resolution_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--epochs 40] [--pn_epochs 4] [--master_steps 300]
        [--master_seg 30] [--hybrid_epochs 40] [--fast_epochs 40]
        [--hybrid_grid_epochs 600] [--pia_steps 300]

Phases, in order; any failure ends the run with a non-zero exit:
1. build: compile ``csrc/siren.cu``, ``csrc/siren_wg.cu``,
   ``csrc/siren_resident_tc.cu``, ``csrc/siren_stream.cu``,
   ``csrc/wire.cu``, ``csrc/wire_tc.cu``,
   ``csrc/conv3d.cu`` and ``csrc/mma_probe.cu`` with nvcc (sm_90a), one
   process each, started together, and print the times and the compiler's
   register/spill report;
2. kernel parity against the plain PyTorch versions on the card, K1-K3 on
   their tensor-core route (``csrc/siren_wg.cu``) and the SIMT kernels of
   ``csrc/siren.cu`` at the same shapes for the record: K3
   ``siren_forward`` at the SIREN flagship (P = 70,000 rows, 256 -> 512x4
   -> 1), the inference chunk (262,144 rows) and its ragged tails (71,424,
   17,856 and the hybrid inference grid's 39,936 rows); K1 ``siren_loss_grads`` with and without masked rows;
   K2 ``siren_fused_bwd`` with and without dW; two calls of each giving the
   same bits; a 20-step Adam fit at the flagship from one init, K1's
   tensor-core route against the plain K1, loss by loss, and the same at
   the hybrid fit's P = 100,800 rows, where K1 is also held to its plain
   version once (twice for the same bits); a 10-step
   PerturbNet Adam trace over 3 acquisitions through the frozen flagship
   INR, K3/K2 on the tensor cores against autograd through the plain
   forward, loss by loss; K1's sample-weighted variant on its
   streaming route (``csrc/siren_stream.cu``) at the 2-D ensemble's
   3,600 rows (2 -> 64x7 -> 1), twice for the same bits, with the SIMT K1-w
   for the record; the batched K1 (K1 under ``jax.vmap`` in the JAX
   package, one launch over stacked MLPs) on both its kernels, each against
   its plain batched version and against D unbatched kernel calls, twice
   for the same bits: ``csrc/siren_wg.cu``'s ``siren_loss_grads_wg`` (wgmma
   fed by TMA, the Pallas K1's bf16 stash) at the hybrid's four TEs on
   100,800 rows, also against the plain version with that stash at
   K1_WG_STASH_TOL, and ``csrc/siren_resident_tc.cu``'s
   ``siren_loss_grads_rtc`` (``mma.sync`` bf16x3 tiles, one cooperative
   launch) at the 2-D ensemble's three directions on 3,600 rows with one
   padded (all-zero-weight) slot, also replayed from a CUDA graph (the same
   bits as an eager call) and a 20-step Adam trace against its plain
   batched version; and its
   absmax/ReLU variant K1-a on its streaming
   tensor-core route (``csrc/siren_stream.cu``) at the soft-ERD fit's 16,384
   rows (2 -> 128x4 -> 128 ReLU -> 1 ReLU), with ragged row counts, with and
   without sample weights and with a collapsed output (max |out| exactly
   0), twice for the same bits, the SIMT K1-a for the record; a 20-step Adam
   fit at phase 1's lr (3e-4) of that network from one init, K1-a's route
   against the plain K1-a, loss by loss; K1-a again at the half-res quality
   harness's LR slice, 64 x 64 = 4,096 rows (32 row tiles) and 63 x 63 =
   3,969 (a last tile of one row), with the output on and collapsed, twice
   for the same bits, and a 20-step Adam trace at 4,096 rows; and the SIMT
   K2/K3 with the ReLU codes;
   P1 ``mma_probe`` (``wgmma``) at one and three steps of its full shape,
   int8 exact and bf16 within float32 rounding; K5 ``wire_forward`` and K4 ``wire_loss_grads``
   at the WIRE path's 4 -> 256x2 -> 1 and at 512x2, on 70,000 rows, the
   chunk and its tails (K5) and with 1234 masked rows (K4), both on their
   tensor-core route ``csrc/wire_tc.cu``, twice for the same bits, the SIMT
   ones for the record, and a 20-step Adam fit (lr 1e-3) of the WIRE path's
   network from one init, K4's route against the plain K4, loss by loss; K6
   ``conv3d_rfab`` at the seven shapes of the MISR path in bf16 and float32,
   at the seven forward shapes of the training path in bf16 and on ragged
   shapes, every bf16 call of the two paths on the wgmma kernel, held also
   to the mma.sync kernel ``conv3d_tc_kernel`` (the share of bit-equal
   outputs) and twice for the same bits; K7 ``conv3d_rfab_bwd`` (dx, dW, db) at the seven
   shapes of the training path in bf16 and float32 and on ragged shapes;
   G1 ``rfab_gate`` (``csrc/rams_gate.cu``) at the four RFAB shapes of the
   MISR path in bf16 against the eager chain (``RFAB.gate_eager``): the
   gate within one bf16 ulp, the output bit for bit wherever the two gates
   agree, twice for the same bits; in float32 and at C 8 on ragged shapes;
   then a small SIREN and a small WIRE patient, a small RAMS forward, three
   training steps of a small RAMS, a small 2-D ensemble case and a small
   soft-ERD phase 1 on the card's kernels against the plain path on the CPU;
3. main paths: ``pipelines.superres3d.run`` on a seeded (128, 128, 28)
   synthetic patient with 75 cross-b combinations, ROI 40:90 -> 25x25x28x4
   = 70,000 LR rows, once at the ``reference`` preset (SIREN 512x3, 128
   mappings, PN 128) and once with ``inr_model="wire"`` at the JAX package's
   WIRE defaults (256x2, omega = sigma = 10, raw coordinates), each with the
   epochs cut to ``--epochs`` and ``--pn_epochs``; checks the
   CSV and timings.json, finite and clamped outputs, a falling loss, and,
   with every launch count set to 0 just before each run, that each kernel
   of the path launched exactly as often as the schedule says (K1 and K4 on
   every mean step, K3 on every inference chunk and PN step and K2 on every
   PN step, K5 on every inference chunk, K1-K5 on their tensor-core route
   and the SIMT ones never) and no other kernel did; then the hybrid tissue
   fit: ``pipelines.hybrid.fit_all_te`` at full width (four SIRENs 256 ->
   512x4 -> 1, ROI 35:95 -> 30x30x28x4 = 100,800 LR rows a TE) on a seeded
   three-compartment patient (``hybrid_from_tissue`` of the same blob) for
   ``--hybrid_epochs``, then ``tissue_maps`` with the NLLS (40 iterations)
   on slice 14 on the card: exactly epochs batched K1 launches (the four
   TEs' SIRENs a launch) on the tensor-core route and 4 x 7 K3 inference
   chunks, no other kernel, the
   per-TE losses falling, the maps finite, within the fit's bounds and v
   summing to 1; then ``make_pia_fitter`` pretraining ``--pia_steps`` on
   the card and ``tissue_maps`` with it (no kernel); then the grid INR:
   ``superres3d.run`` on the 3-D patient at the ``quality`` preset
   (``--epochs``, ``--pn_epochs``) and the ``fast`` preset
   (``--fast_epochs``, no PN epochs), no kernel launched, and a 20-epoch
   quality trace from one init on the card against the CPU, loss by loss,
   with a control run on TF32 products that its bars must catch; then the
   hybrid fit's grid arm: ``fit_all_te`` at the ``fast`` preset's settings
   (GridINR L4, base 6, F 4, hidden 64, restart_adam(5e-3, 250),
   ``--hybrid_grid_epochs``, 600) on the hybrid patient, the four TEs one
   batched fit on 100,800 rows each: no kernel launched, the per-TE losses
   falling, a finite (120, 120, 28, 4, 4) recon >= 0; a 20-epoch trace
   (restarts every 8) from one init, card batched against CPU batched and
   against the four TEs fitted in turn on the card, loss by loss; fit_s
   batched against in turn, alternating, the two batched runs equal bit
   for bit; 50 steps of each under ``torch.profiler``;
   then ``pipelines.misr.run`` on
   two seeded synthetic cases (b0 (128, 128, 24), 27 acquisitions, 25
   draws) with the committed RAMS checkpoint at full width in bf16 with
   ``conv_kernel=True``: DICOMs, timings.json, finite (384, 384) outputs in
   [0, 65536], exactly 34 K6 launches, all 34 on the wgmma kernel, and 15
   G1 gates per case (no eager RFAB gate) and no other kernel;
   the same cases on the library route and in float32 bound the route gap;
   then the MISR trainer, ``cli/train_misr.main`` at full width (filters 32,
   N 12, bf16, ``--conv_kernel``, batch 32, hr 96) on three seeded
   synthetic mean-b0 volumes (128, 128, 24) written with scipy: 4 optimizer
   steps and 3 validation passes, a finite loss and cPSNR, moved params, a
   restorable checkpoint, the CSV log, and exactly 34 K6 + 34 K7 launches
   per step, 34 K6 and no K7 per validation batch, no K1-K5; then the 2-D
   directional ensemble, ``cli/master.main`` at full width (Siren 64x6,
   ROI 40:100, scale 3, AutoERD mode 1) on one seeded synthetic case (b0
   (128, 128, 24), 27 acquisitions (9, 9, 9)) with the steps cut to
   ``--master_steps`` and ``--master_seg``: CSV, DICOMs, finite outputs and
   exactly steps x 9 batched K1-weighted launches (the three directions a
   launch, one a acquisition slot) on ``csrc/siren_resident_tc.cu`` and no
   other kernel (none of the SIMT or unbatched K1-w); then the
   soft-ERD fit, ``cli/inr_erd.main`` at full width (SirenERD 128x3, 9
   acquisitions, one seed) on the same kind of volume with phase 1 run to
   the reference's 2e-5 (about 700 steps): CSV, checkpoints, and exactly one K1-absmax
   launch on the streaming route per phase-1 step and no other kernel (none
   of the SIMT K1-a); then phase 1 on that case's target from one init on
   the streaming and the SIMT route in turns: both stop steps, restart
   lists and wall-clocks printed side by side; then the half-res quality
   harness, ``cli/superres_lowres.main`` at full width (SirenERD 128x3, 9
   acquisitions, the cancer slice of a seeded 128 x 128 volume, phase 1 on
   the 64 x 64 LR slice to 2e-5, 500 phase-2 steps) with the reference and
   the split protocol: the CSV, a (128, 128) SR, phase 1 before its step
   bound, exactly one K1-a launch on the streaming route a phase-1 step and
   no other kernel, phase 1's and phase 2's wall-clocks; then short runs of
   ``cli/david.main``, ``cli/inr_toy.main`` (500 steps) and
   ``cli/automate_inr.main --use_pn`` (200 epochs) on the card, no kernel
   launched, their outputs checked; then the P1 probe,
   ``cli/int8_mma_probe.main`` at its full shape (T 384, H 512, REPS 8,
   GRID 512): the JAX probe's JSON keys and 11 launches per type; then
   ``core/autodiff.py``'s gradient and Laplacian of the flagship SIREN
   (behind a 128-mapping encoding of 4-D coordinates) at 4,096 points, card
   against CPU; then ``serve.py`` at full width: a SIREN 256 -> 512x4 -> 1
   with its Fourier B, a WIRE 4 -> 256x2 -> 1, a GridINR at the quality
   preset's widths, a PIA (S = 16) and the committed RAMS at 96 x 96 in
   bf16, each exported on the card (a cuda and a cpu program), loaded back
   on both devices and served (batch 1 included) against the live module
   at the export CLI's bars, the cuda program against the cpu one; the
   served SIREN on a 262,144-row chunk timed against the live plain SIREN
   and K3, the served RAMS's 25-draw forward against the live library route
   and the K6 route; then ``superres3d.run(export_artifact=True)`` at the
   ``reference`` and ``quality`` presets (``--epochs``, ``--pn_epochs``):
   the launches exactly as without the export, the artifact served on the
   HR grid against the fitted INR on K3 (SIREN) or the tensor path (grid);
   then the blinded qualitative study, ``qual_study.build_panel`` at full
   width (one synthetic 128 x 128 case, 9 acquisitions, SirenERD 128x3,
   phase 1 to 2e-5 on the 64 x 64 LR rows, 500 fine-tune steps): exactly
   one streaming K1-a launch a phase-1 step and no other kernel, phase 1,
   the fine-tune, the reconstruction and the scoring timed, the panel's
   perceptual scores on the card against the CPU's; then the loaders: a v5
   file (numeric, cell, struct, char) through ``load_mat(prefer_native=True)``
   and the C++ prefetch pool against scipy, and ``load_cases`` of four
   registry cases (whether the C++ reader was used is printed); then the
   cohort runner, ``cli.cohort_run.main`` at full width (four registry
   cases, Siren 64x6, ROI 40:100, 1000 steps, uncut): every loss falls,
   finite recons, no kernel launched, and a 20-step trace from one injected
   init on the card against the CPU; then the parallel layer on two gloo
   ranks sharing the card (``parallel.distributed.spawn_ranks``): the
   flagship SIREN's data-parallel fit on K1 (70,000 rows, 35,000 a rank, 5
   steps, exactly 5 tensor-core K1 launches a rank), the ragged fit (69,997
   rows padded to 69,998), the tensor-parallel fit (3 steps, width 512 over
   the two ranks, no kernel), each against one rank loss by loss; a sharded
   checkpoint round trip (``torch.distributed.checkpoint``); the engine's
   three fits with ``mesh=`` on the same ranks: ``fit_ensemble_batched``
   at the 2-D ensemble's full width (three directions of nine acquisitions,
   3,600 rows, 1,800 a rank; 20 steps, a tail of 5; exactly 180 batched
   K1-w launches a rank), ``fit_alternating_pn`` at the flagship (70,000
   rows, 35,000 a rank, 75 acquisitions, 14 epochs, 4 alternating: 12 K1
   and 150 K3 and K2 launches a rank) and ``fit_until`` (soft-ERD phase 1 on
   the soft-ERD case's 16,384-row target, 8,192 a rank, to 2e-5: one
   streaming K1-a launch a step), the ranks bit-equal, each trace against
   one rank in its stated window (SHARD_ENS_WINDOW), phase 1's stop within
   5% of one rank's, both stop steps printed, and a 2-step ensemble whose
   gathered predictions are its final params' on the whole grids; and
   ``train_misr.main --data_parallel --conv_kernel`` at full-width RAMS
   (batch 32, 16 a rank, 2 steps; exactly 34 K6 + 34 K7 launches a step on
   each rank) against one rank's two step losses; ms a step on two ranks and
   on one printed; then the port's three examples: ``phantom_sanity`` as it
   stands (its gates; one streaming K1-a launch a phase-1 step),
   ``sr3d_demo --epochs 60`` (K1-K3 on the tensor cores, counted exactly)
   and ``wire_vs_siren --steps 100`` (plain autograd, no kernel);
4. times: each kernel at its main path's shapes with CUDA events, beside
   its plain version, the library equivalent (eager autograd; ``F.conv3d``
   for K6, ``torch.autograd.grad`` through it for K7; ``torch.matmul`` in
   bf16 and ``torch._int_mm`` over the same products for P1) and its bound
   (K1-K4's tensor-core route: its bf16x3 products at the bf16 peak; the
   SIMT K1-K5's times at the same shapes printed beside them, routes in
   turns, K3 also at the inference chunk; each one's device time by pass
   under ``torch.profiler``, K5 at the inference chunk too; K1-weighted's
   and K1-absmax's two routes in turns and by pass; each batched K1 beside
   D unbatched calls in turns, and by pass, the tensor-core one's passes
   (profiled in a fresh process) beside their product bound and bytes);
   K6 and K7 with their library calls in three alternating rounds, best of
   each, the ratios to the library and to the bound printed at every path
   shape, K6's wgmma and mma.sync kernels in three alternating rounds at
   each serving shape and summed over a case's 34 launches; G1 and the
   eager chain it replaces in three alternating rounds at the four RFAB
   shapes, beside its plain version and its bound (x, res and
   the output moved once at 3.35 TB/s), and its three passes by time; P1 also at GRID 256, whose time must be about half; the
   per-update costs of the two 2-D paths (a K1 call on either route, an
   Adam step, a whole update, ``fit_until``'s per-step read-back, the
   soft-ERD step on both K1-a routes; the batched 2-D update of the three
   directions, a batched K1-w call and a stacked Adam step, beside three
   unbatched updates); the shapes of the fits on two ranks, each held to
   its plain version first: the batched K1-w at 1,800 rows, K1-a at 8,192,
   K3 and K2 at 35,000; K1-a at the half-res LR slice beside
   its plain version, eager autograd and its bound, by pass; the
   25-draw RAMS forward on both
   routes; one full training step at batch 32 on both routes, whose losses
   over the same three steps from the same init differ by at most twice the
   cuDNN route's own bf16-vs-float32 gap; one forward and one step per route
   under ``torch.profiler`` for the device's busy time and idle share.

The last three lines are the ``{"kernels": ...}`` record (K1-K5 on their
tensor-core route, K1 also at the hybrid's shape and at a shard's 35,000
rows, K6-K7, G1 at the body's RFAB shape, K1's weighted
and absmax variants on their streaming route, the latter also at the half-res
LR slice, P1 in bf16 and int8, the batched K1 on its two kernels, and the
batched K1-w, K1-a, K3 and K2 at a rank's shard of the fits on two ranks:
21 rows; each row's launches are its own entry's on the main path, so the
unbatched K1 row at the hybrid's shape and the unbatched K1-weighted row,
whose paths now run the batched entries, count 0),
the card's name and
power limit, and ``{"ok": true, "device": ...}``. Exits non-zero, printing
no result, when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12  # float32 FMA outside the tensor cores
PEAK_BF16_TC = 989e12  # bf16 dense tensor cores
PEAK_INT8_TC = 1979e12  # int8 dense tensor cores
PEAK_BYTES = 3.35e12  # HBM3

SOURCES = ("siren", "siren_wg", "siren_resident_tc", "siren_stream", "wire", "wire_tc",
           "conv3d", "rams_gate", "mma_probe")  # csrc/<name>.cu
K3_TOL = 1e-4  # max |kernel - plain| / max |plain|, forward
K1_K2_TOL = 1e-3  # the same for the loss, dx and each dW/db (sums over P rows)
# the batched K1 (csrc/siren_wg.cu) against the plain version with the same
# bf16 stash: bf16x3 products and another order of sums move z by about
# 1e-6 relative, enough to flip a few stashed values by one bf16 ulp (2^-8):
# measured 1.6e-4 of the largest value at the hybrid's shape on an H100;
# against the float32 plain version and the unbatched K1, K1_K2_TOL
K1_WG_STASH_TOL = 5e-4
# K1's tensor-core route (bf16x3 products) held to K1_K2_TOL too; a 20-step
# Adam fit (lr 1e-4, the mean fit's) from one init, its loss at each step
# within K1_TRACE_RTOL of the plain K1's (fits are chaotic: compare short
# traces step by step, not end points).
# Adam divides each gradient component by its own scale, so the components
# within the route's error (about 5e-5 of the largest) of zero take steps of
# another size or sign: the traces part by up to 9.5e-4 in 20 steps on an
# H100, while the loss falls 3.7-fold
K1_TRACE_STEPS, K1_TRACE_RTOL = 20, 5e-3
# the PerturbNet steps through K3 and K2 on their tensor-core route, held to
# K1_TRACE_RTOL step by step against autograd through the plain forward
PN_TRACE_STEPS, PN_TRACE_ACQ = 10, 3
K5_TOL = 1e-4  # WIRE forward, as K3
K4_TOL = 1e-3  # WIRE loss and every dW, as K1
# K4's tensor-core route (bf16x3 products) held to K4_TOL too, and a
# K1_TRACE_STEPS-step Adam fit at the WIRE fit's lr of 1e-3 from one init to
# K1_TRACE_RTOL of the plain K4's losses, step by step
K4_TRACE_LR = 1e-3
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
# the MISR path's RFAB gates (G1, csrc/rams_gate.cu): (x's shape, gates per
# forward): the N body RFABs, then one per temporal step on the padded planes
G1_SHAPES = (
    ((25, 130, 130, 9, 32), 12),
    ((25, 132, 132, 9, 32), 1),
    ((25, 132, 132, 7, 32), 1),
    ((25, 132, 132, 5, 32), 1),
)
G1_PER_FORWARD = sum(n for _, n in G1_SHAPES)  # N + T // 3 = 15
# K7 dW and db: max |kernel - plain| / max |plain|. Float32 sums over every
# output pixel (up to 3.7e5 rows at the training shapes) in other orders:
# the K1 class would be 1e-3; measured at most 1.53e-6 on an H100 over the
# seven training shapes and four ragged ones, both types, so 1e-5
K7_DW_TOL = 1e-5
# the training path's K6/K7 shapes: batch 32 of 32 x 32 LR patches (hr 96),
# reflect-padded to 34, then 36 before each temporal step
TRAIN_SHAPES = (
    ((32, 34, 34, 9, 32), "SAME", 25),
    ((32, 36, 36, 9, 32), "SAME", 2),
    ((32, 36, 36, 7, 32), "SAME", 2),
    ((32, 36, 36, 5, 32), "SAME", 2),
    ((32, 36, 36, 9, 32), "VALID", 1),
    ((32, 36, 36, 7, 32), "VALID", 1),
    ((32, 36, 36, 5, 32), "VALID", 1),
)
TRAIN_BATCH = 32  # TrainerConfig.batch_size
TRAIN_STEPS, TRAIN_VAL_PASSES = 4, 3  # 2 epochs of 2 steps; val at steps 2, 4 and at the end
INFER_CHUNK = 262_144  # rows per inference chunk (fit/engine.py:infer_dense_grid)
# the 2-D ensemble's K1 call: the 60 x 60 ROI, Siren 2 -> 64x7 -> 1
MASTER_P, MASTER_HIDDEN, MASTER_LAYERS = 3600, 64, 6
MASTER_ACQ = 27  # acquisitions (9, 9, 9)
# the 2-D ensemble's acquisition slots a step (the most of one direction):
# one batched K1-weighted launch each over the three directions
MASTER_SLOTS, MASTER_DIRS = 9, 3
HYBRID_TES = 4  # the hybrid fit's per-TE SIRENs: one batched K1 launch a step
# the soft-ERD fit's K1 call: a 128 x 128 slice, SirenERD 2 -> 128x4 -> 128 -> 1
ERD_SIDE, ERD_HIDDEN, ERD_LAYERS = 128, 128, 3
ERD_THRESHOLD = 2e-5  # INRERDConfig.loss_threshold, the reference's
ERD_LR = 3e-4  # INRERDConfig.pretrain_lr: phase 1's Adam
K1_ABSMAX_TOL = 1e-5  # max |out|: the max is exact, the outputs it reads are float32 sums
# K1-a's loss on the streaming route (bf16x3 products): within 1e-5 relative
# (a CPU model of the split at SirenERD's init: 1.8e-7)
K1A_LOSS_RTOL = 1e-5
# the half-res quality harness (superres-lowres): phase 1's K1-a on the 0.5x
# LR slice of a 128 x 128 slice, 64 x 64 = 4,096 rows (32 row tiles of the
# streaming route, on 132 SMs), and of an odd side's 63 x 63 = 3,969 rows
# (31 tiles and a last tile of one row)
LOWRES_SIDE, LOWRES_RAGGED_SIDE = 64, 63
# the hybrid tissue fit (superresHybrid): ROI 35:95 of a (128, 128, 28)
# patient, its ::2 LR grid 30 x 30 x 28 x 4 a TE, four per-TE SIRENs at the
# flagship widths; inference on the (120, 120, 28, 4) grid, the tissue maps
# on the middle slice
HYBRID_P, HYBRID_SLICE = 30 * 30 * 28 * 4, 14
HYBRID_INFER = 120 * 120 * 28 * 4
BVALS = (0.0, 150.0, 1000.0, 1500.0)
PIA_STEPS = 300  # noise-range pretraining steps of the PIA fitter
# the grid INR's mean steps and PerturbNet steps on the card against the
# CPU from one init, loss by loss, and the recon: float32 sums in other
# orders (the gather backward's atomics among them), through Adam. Measured
# on an H100 (NVIDIA H100 80GB HBM3, 700 W): 2.9e-6 worst step rel and 2.2e-4
# max abs on the recon, so bars of 1e-4 and 5e-4. A control run with TF32
# products must exceed one of them: the bars see TF32 left on
GRID_TRACE_STEPS, GRID_TRACE_PN = 20, 4
GRID_TRACE_RTOL, GRID_RECON_ATOL = 1e-4, 5e-4
# the hybrid fit's grid arm (the fast preset: four GridINRs L4, base 6, F 4,
# hidden 64, z_divisor 1 on the 30 x 30 x 28 x 4 LR grid, restart_adam(5e-3,
# 250), 600 epochs) as one batched fit: a HYBRID_GRID_TRACE-epoch trace from
# one init with the moments restarted every HYBRID_GRID_RESTART steps, on
# the card against the CPU (the loss a step relative, the recon's largest
# gap over its largest value), and batched against the four TEs fitted in
# turn on the card (the loss a step): float32 sums in other orders through
# Adam, TF32 off. Measured on an H100 (NVIDIA H100 80GB HBM3, 700 W):
# 4.5e-6, 9.5e-4 and 1.0e-5 (2.7e-5, 1.4e-3 and 2.6e-5 before the head's
# weight gradients were summed in row chunks), so bars of 5e-5, 5e-3 and
# 5e-5
HYBRID_GRID_TRACE, HYBRID_GRID_RESTART = 20, 8
HYBRID_GRID_TRACE_RTOL, HYBRID_GRID_RECON_TOL, HYBRID_GRID_TURN_RTOL = 5e-5, 5e-3, 5e-5
# P1 at the JAX probe's shape
PROBE_T, PROBE_H, PROBE_REPS, PROBE_GRID = 384, 512, 8, 512
PROBE_CALLS = 10  # timed calls of the probe CLI, after one untimed
# bf16 P1 against its plain version: float32 sums of 4,096 exact products in
# another order (and the tensor cores' own), within 1e-5 of the largest
PROBE_BF16_TOL = 1e-5
# serving (serve.py): a served artifact against its live module at the
# export CLI's --check bars (max error over the largest magnitude): 1e-4 for
# the float32 kinds (SIREN, WIRE, GridINR, PIA), 2e-2 for the bf16 RAMS; an
# artifact's cuda program against its cpu program at the same bars (cuBLAS
# and cuDNN against the CPU's libraries, float32 sums and bf16 roundings in
# other orders)
SERVE_TOL, SERVE_RAMS_TOL = 1e-4, 2e-2
SERVE_RAMS_SIDE, SERVE_RAMS_DRAWS = 96, 25  # the export CLI's patch, the 25-draw ensemble
# superres3d.run(export_artifact=True): the served artifact on the HR grid
# against the fitted INR on the pipeline's own inference route (K3 on the
# card for SIREN, the tensor path for the grid), the CLI's 1e-4
EXPORT_TOL = 1e-4
# the blinded qualitative study: a panel's scores on the card against the
# CPU's, float64 keys relative, the float32 SSIM keys absolute
QUAL_SEED, QUAL_FINE_TUNE = 291, 500
PERCEPTUAL_RTOL, PERCEPTUAL_SSIM_ATOL = 1e-9, 1e-5
# core/autodiff.py: the flagship SIREN's gradient and Laplacian at 4,096
# 4-D points on the card against the CPU, max error over the largest
# magnitude (float32 sums in other orders through omega 30)
AUTODIFF_P, AUTODIFF_TOL = 4096, 1e-4


# the cohort runner (BASELINE config 5): four registry cases, Siren 64x6 on
# the 60 x 60 ROI, 1000 steps; a 20-step trace from one injected init on the
# card against the CPU, loss by loss (float32 sums in other orders through
# Adam, the grid trace's bar)
COHORT_CASES, COHORT_STEPS = 4, 1000
COHORT_TRACE_STEPS, COHORT_TRACE_RTOL = 20, 1e-4
# the parallel layer on two gloo ranks sharing the card: the data-parallel
# and ragged K1 fits (5 steps) and the tensor-parallel fit (3 steps) against
# one rank, loss by loss, at the JAX dry run's 1e-4 (reduction orders
# differ between one rank and two); the trainer's two steps at batch 32
# over two ranks against one rank within 1e-3 relative, a quarter of bf16's
# 2^-8 (K7 sums the batch's dW in halves; the bf16 activations round after
# the params part by Adam's sign flips of near-zero gradient components)
SHARD_STEPS, TP_STEPS, SHARD_RTOL, TRAIN_DP_RTOL = 5, 3, 1e-4, 1e-3
# the engine's three fits on the data axis of the same two ranks, at full
# width: the 2-D ensemble (three directions of nine acquisitions on the 60 x
# 60 ROI, 1,800 rows a rank; eval grids of 3,600 and 32,400 rows) for 20
# steps with a tail of 5; the 3-D main path's schedule at the flagship (75
# acquisitions, 35,000 rows a rank) for 14 epochs, 4 of them alternating;
# soft-ERD phase 1 (16,384 rows, 8,192 a rank) to ERD_THRESHOLD. The ranks
# bit-equal; against one rank, whose one sum rounds otherwise than two
# half-sums, each loss trace at SHARD_RTOL within a window: the alternating
# fit's whole 14 epochs; the ensemble's first SHARD_ENS_WINDOW steps (45
# updates) and phase 1's first K1_TRACE_STEPS, since Adam amplifies the
# rounding of near-zero gradient components from update to update (on an
# H100, NVIDIA H100 80GB HBM3, 700 W, the ensemble's random-target trace
# drifted to 4.9e-3 by step 20 on the kernel route and 2.5e-3 on the plain
# one, phase 1's to 0.63 at a loss spike, stopping at 738 against 725);
# phase 1's stop step within SHARD_STOP_FRAC of one rank's; and a
# SHARD_ENS_SHORT-step ensemble's trace at SHARD_RTOL, with a tail of one
# step, whose gathered predictions are the INR of its final params on the
# whole grids (at SHARD_RTOL of their largest magnitude)
SHARD_ENS_STEPS, SHARD_ENS_SEG, SHARD_ENS_WINDOW, SHARD_ENS_SHORT = 20, 5, 5, 2
SHARD_ALT_EPOCHS, SHARD_ALT_PN, SHARD_ALT_ACQ = 14, 4, 75
SHARD_STOP_FRAC = 0.05


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
        kernel = "?"
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if "Function properties for" in line:
                kernel = _demangled(line.split()[-1])
            elif "registers" in line or "spill" in line:
                print(f"[build] {name} {kernel}: {line.strip()}")


def _demangled(symbol: str) -> str:
    """The kernel's name from its mangled symbol (the first name past the
    anonymous namespace), with its template arguments' mangling kept."""
    rest = symbol
    while (m := re.match(r"(?:_ZN|_Z)?(\d+)", rest)):
        n = int(m.group(1))
        name, rest = rest[m.end():m.end() + n], rest[m.end() + n:]
        if not name.startswith("_GLOBAL"):
            return name + (rest[:rest.index("E")] if rest.startswith("I") else "")
    return symbol


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

    from mri_super_resolution_tpu_torch.ops import _build
    from mri_super_resolution_tpu_torch.ops import wire_kernel as wk

    errs = {"wire_forward_tc": 0.0, "wire_loss_grads_tc": 0.0}
    stream = _build.stream_ptr()
    for H in (256, 512):
        model, x, target = _wire_inputs(P, H, 2, seed=H)
        ws, _, oms = wk.split_params(model.params(), 2)
        gen = torch.Generator().manual_seed(H + 1)
        for n in (P, INFER_CHUNK, 1_120_000 % INFER_CHUNK, 280_000 % INFER_CHUNK):
            xn = x if n == P else (torch.rand(n, 4, generator=gen) * 2.0 - 1.0).cuda()
            before = dict(wk.LAUNCHES)
            out = wk.wire_forward(xn, ws, oms)
            again = wk.wire_forward(xn, ws, oms)
            _require(wk.LAUNCHES == {**before, "wire_forward_tc": before["wire_forward_tc"] + 2},
                     f"K5 at H={H} did not take the tensor-core route")
            ref = wk.wire_forward_ref(xn, ws, oms)
            e, r = _rel(out, ref)
            r_simt = _rel(wk._launch_forward(wk._lib(), xn, ws, oms, stream), ref)[1]
            print(f"[parity] K5 wire_forward H={H} P={n}, tensor-core route: max abs {e:.3e}, "
                  f"rel {r:.3e} (tol rel {K5_TOL:g}); SIMT (csrc/wire.cu) rel {r_simt:.3e}")
            _require(r <= K5_TOL, f"K5 disagrees with its plain version (H={H}, P={n})")
            _require(r_simt <= K5_TOL,
                     f"the SIMT K5 (csrc/wire.cu) disagrees with its plain version (H={H})")
            _require(torch.equal(out, again), "two tensor-core K5 calls differ")
            errs["wire_forward_tc"] = max(errs["wire_forward_tc"], e)
            del xn, out, again, ref
        _require(wk.wire_tc_route(H, 2), f"K4 at H={H} is not of the tensor-core route's class")
        for n_rows in (P, P - 1234):
            before = dict(wk.LAUNCHES)
            loss, grads = wk.wire_loss_grads(x, ws, oms, target, n_rows=n_rows)
            again = wk.wire_loss_grads(x, ws, oms, target, n_rows=n_rows)
            simt = wk._launch_loss_grads(wk._lib(), x, ws, oms, target, n_rows, stream)
            loss_r, grads_r = wk.wire_loss_grads_ref(x, ws, oms, target, n_rows=n_rows)
            torch.cuda.synchronize()
            _require(wk.LAUNCHES == {**before,
                                     "wire_loss_grads_tc": before["wire_loss_grads_tc"] + 2},
                     f"K4 at H={H} did not take the tensor-core route")
            e, r = _worst_rel([(loss, loss_r), *zip(grads, grads_r)])
            per = [_rel(a, b)[1] for a, b in zip(grads, grads_r)]
            r_simt = _worst_rel([(simt[0], loss_r), *zip(simt[1], grads_r)])[1]
            print(f"[parity] K4 wire_loss_grads H={H} n_rows={n_rows}, tensor-core route: loss "
                  f"{float(loss):.6e} vs {float(loss_r):.6e} (rel "
                  f"{_rel(loss, loss_r)[1]:.3e}); worst over loss/dW max abs {e:.3e}, rel "
                  f"{r:.3e} (tol rel {K4_TOL:g}); by weight "
                  f"{', '.join(f'{v:.1e}' for v in per)}; SIMT (csrc/wire.cu) rel "
                  f"{r_simt:.3e}")
            _require(r <= K4_TOL, f"K4 disagrees with its plain version (H={H})")
            _require(r_simt <= K4_TOL,
                     f"the SIMT K4 (csrc/wire.cu) disagrees with its plain version (H={H})")
            _require(torch.equal(loss, again[0])
                     and all(torch.equal(a, b) for a, b in zip(grads, again[1])),
                     "two tensor-core K4 calls differ: the reductions are not in a fixed order")
            errs["wire_loss_grads_tc"] = max(errs["wire_loss_grads_tc"], e)
        del model, x, target
    return errs


def phase_parity(P: int, dims) -> dict:
    """Each kernel against its plain version on the card; returns max abs
    errors by kernel."""
    import torch

    from mri_super_resolution_tpu_torch.ops import _build
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    x, ws, target, g = _flagship_inputs(P, dims, seed=0)
    errs = {}
    _require(sk.tc_route(dims, ("sine",) * (len(dims) - 2) + ("none",)),
             "the flagship is not of the tensor-core route's class")

    # K3 on its tensor-core route at the PerturbNet's P rows, the inference
    # chunk and the ragged tails of the 2x grid (1,120,000 rows), the HR
    # grid (280,000 rows) and the hybrid fit's inference grid (HYBRID_INFER
    # rows a TE); the SIMT K3 at the same shapes for the record
    xc, wsc, _, _ = _flagship_inputs(INFER_CHUNK, dims, seed=2)
    before = dict(sk.LAUNCHES)
    e = 0.0
    shapes = (P, INFER_CHUNK, 1_120_000 % INFER_CHUNK, 280_000 % INFER_CHUNK,
              HYBRID_INFER % INFER_CHUNK)
    for n in shapes:
        xn, wn = (x, ws) if n == P else (xc[:n], wsc)
        out = sk.siren_forward(xn, wn)
        simt = sk._launch_forward(sk._lib(), xn, wn, 30.0, _build.stream_ptr())
        ref = sk.siren_forward_ref(xn, wn)
        torch.cuda.synchronize()
        en, rn = _rel(out, ref)
        print(f"[parity] K3 siren_forward P={n}: tensor-core route max abs {en:.3e}, rel "
              f"{rn:.3e}; SIMT rel {_rel(simt, ref)[1]:.3e} (tol rel {K3_TOL:g})")
        _require(rn <= K3_TOL and _rel(simt, ref)[1] <= K3_TOL,
                 f"K3 disagrees with its plain version at P={n}")
        e = max(e, en)
        if n == P:
            _require(torch.equal(out, sk.siren_forward(xn, wn)),
                     "two tensor-core K3 calls differ")
    del xc, wsc
    _require(sk.LAUNCHES["siren_forward_wg"] == before["siren_forward_wg"] + len(shapes) + 1
             and sk.LAUNCHES["siren_forward"] == before["siren_forward"],
             "K3 at the flagship's widths did not take the tensor-core route")
    errs["siren_forward_wg"] = e

    loss_r, grads_r = sk.siren_loss_grads_ref(x, ws, target)
    tc_before = sk.LAUNCHES["siren_loss_grads_wg"]
    loss, grads = sk.siren_loss_grads(x, ws, target)
    simt_loss, simt_grads = sk._launch_loss_grads(sk._lib(), x, ws, target, 30.0, P,
                                                  _build.stream_ptr())
    torch.cuda.synchronize()
    _require(sk.LAUNCHES["siren_loss_grads_wg"] == tc_before + 1,
             "K1 at the flagship did not take the tensor-core route")
    for what, (l_k, g_k) in (("tensor-core route", (loss, grads)),
                             ("SIMT (csrc/siren.cu)", (simt_loss, simt_grads))):
        worst = _worst_rel([(l_k, loss_r), *zip(g_k, grads_r)])
        print(f"[parity] K1 siren_loss_grads, {what}: loss {float(l_k):.6e} vs "
              f"{float(loss_r):.6e}; worst over loss/dW/db max abs {worst[0]:.3e}, "
              f"rel {worst[1]:.3e} (tol rel {K1_K2_TOL:g})")
        _require(worst[1] <= K1_K2_TOL, f"K1 ({what}) disagrees with its plain version")
    errs["siren_loss_grads_wg"] = max(float((loss - loss_r).abs()),
                                      *[float((a - b).abs().max())
                                        for a, b in zip(grads, grads_r)])
    loss2, grads2 = sk.siren_loss_grads(x, ws, target)
    _require(torch.equal(loss, loss2) and all(torch.equal(a, b) for a, b in zip(grads, grads2)),
             "two tensor-core K1 calls differ: the reductions are not in a fixed order")

    nr = P - 1234  # masked ragged rows
    loss_m, grads_m = sk.siren_loss_grads(x, ws, target, n_rows=nr)
    loss_mr, grads_mr = sk.siren_loss_grads_ref(x, ws, target, n_rows=nr)
    torch.cuda.synchronize()
    worst_m = _worst_rel([(loss_m, loss_mr), *zip(grads_m, grads_mr)])
    print(f"[parity] K1 tensor-core route n_rows={nr}: worst rel {worst_m[1]:.3e}")
    _require(worst_m[1] <= K1_K2_TOL, "K1 row mask disagrees")

    # K2 on its tensor-core route with dW and without (the PerturbNet step);
    # the SIMT K2 at the same shape for the record
    dx_r, dgr_r = sk.siren_fused_bwd_ref(x, ws, g)
    before = dict(sk.LAUNCHES)
    e = 0.0
    for need_dw in (True, False):
        got = sk.siren_fused_bwd(x, ws, g, need_dw=need_dw)
        again = sk.siren_fused_bwd(x, ws, g, need_dw=need_dw)
        simt = sk._launch_fused_bwd(sk._lib(), x, ws, g, 30.0, need_dw, True,
                                    _build.stream_ptr())
        torch.cuda.synchronize()
        want = [dx_r, *(dgr_r if need_dw else [])]
        for what, (dx, dgr) in (("tensor-core route", got), ("SIMT (csrc/siren.cu)", simt)):
            worst = _worst_rel(zip([dx, *(dgr or [])], want))
            print(f"[parity] K2 siren_fused_bwd {'dx, dW, db' if need_dw else 'dx only'}, "
                  f"{what}: dx max abs err {_rel(dx, dx_r)[0]:.3e} (max |dx| "
                  f"{float(dx_r.abs().max()):.3e}); worst max abs {worst[0]:.3e}, rel "
                  f"{worst[1]:.3e} (tol rel {K1_K2_TOL:g})")
            _require(worst[1] <= K1_K2_TOL, f"K2 ({what}) disagrees with its plain version")
        _require(all(torch.equal(a, b) for a, b in zip([got[0], *(got[1] or [])],
                                                       [again[0], *(again[1] or [])])),
                 "two tensor-core K2 calls differ: the reductions are not in a fixed order")
        e = max(e, _worst_rel(zip([got[0], *(got[1] or [])], want))[0])
    _require(sk.LAUNCHES["siren_fused_bwd_wg"] == before["siren_fused_bwd_wg"] + 4
             and sk.LAUNCHES["siren_fused_bwd"] == before["siren_fused_bwd"],
             "K2 at the flagship's widths did not take the tensor-core route")
    errs["siren_fused_bwd_wg"] = e
    return errs


def phase_pn_trace(P: int, dims) -> None:
    """PN_TRACE_STEPS PerturbNet Adam steps at the flagship (the pipeline's
    step: PerturbNet on the encoded coordinates, its output encoded again,
    the frozen INR, the MSE to one acquisition, the PerturbNet's gradient),
    over PN_TRACE_ACQ acquisitions in turn, from one init: the INR through
    ``siren_fused`` (K3 forward, K2 backward for dx, both on the tensor
    cores) against autograd through the plain ``siren_forward_ref``, loss
    by loss. Each acquisition's target is the INR at a per-row offset that
    the PerturbNet can express (at most eps / 2 on each axis), so the loss
    falls when the gradient is right; lr 1e-3, a thousand times the
    pipeline's 1e-6, so that ten steps move it."""
    import torch

    from mri_super_resolution_tpu_torch.core.coords import fourier_encode, fourier_matrix, mgrid
    from mri_super_resolution_tpu_torch.fit.losses import mse
    from mri_super_resolution_tpu_torch.fit.optim import Adam
    from mri_super_resolution_tpu_torch.models import PerturbNet, Siren
    from mri_super_resolution_tpu_torch.models.perturbnet import perturbnet_apply
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    gen = torch.Generator().manual_seed(11)
    shape = (25, 25, 28, 4)
    _require(P == 25 * 25 * 28 * 4, "the PN trace runs at the flagship's 70,000 rows")
    coords = mgrid(shape, device="cuda")
    B = fourier_matrix(gen, dims[0] // 2, len(shape), device="cuda")
    ff = fourier_encode(coords, B)
    inr = Siren(dims[0], dims[1], len(dims) - 3, generator=gen, device="cuda")
    inr.requires_grad_(False)
    ws = inr.weights()
    pn = PerturbNet(ff.shape[1], 128, len(shape), generator=gen, device="cuda")
    eps = 1.0 / 128.0
    with torch.no_grad():
        targets = []
        for _ in range(PN_TRACE_ACQ):
            M = torch.randn(len(shape), len(shape), generator=gen).cuda()
            targets.append(sk.siren_forward_ref(
                fourier_encode(0.5 * eps * torch.tanh(coords @ M), B), ws))
    traces = {}
    before = dict(sk.LAUNCHES)
    for route, apply in (("kernel", sk.siren_fused), ("plain", sk.siren_forward_ref)):
        params = [w.detach().clone() for w in pn.weights()]
        opt = Adam(params, 1e-3)
        losses = []
        for step in range(PN_TRACE_STEPS):
            a = step % PN_TRACE_ACQ
            leaves = [p.detach().requires_grad_() for p in params]
            enc = fourier_encode(perturbnet_apply(leaves, ff, float(a), eps), B)
            loss = mse(apply(enc, ws), targets[a])
            opt.step(torch.autograd.grad(loss, leaves))
            losses.append(loss.detach())
        traces[route] = torch.stack(losses).tolist()
    _require(sk.LAUNCHES == {**before,
                             "siren_forward_wg": before["siren_forward_wg"] + PN_TRACE_STEPS,
                             "siren_fused_bwd_wg": before["siren_fused_bwd_wg"] + PN_TRACE_STEPS},
             "the PerturbNet steps did not run K3 and K2 on the tensor cores once each")
    k, p = traces["kernel"], traces["plain"]
    rel = max(abs(a / b - 1.0) for a, b in zip(k, p))
    n = PN_TRACE_ACQ
    print(f"[parity] PN {PN_TRACE_STEPS}-step Adam trace at the flagship over {n} "
          f"acquisitions in turn, K3/K2 tensor-core route vs plain autograd: loss by step "
          f"{', '.join(f'{v:.4e}' for v in p)} (plain), last {k[-1]:.4e} (kernel); worst "
          f"step rel {rel:.3e} (tol {K1_TRACE_RTOL:g})")
    _require(rel <= K1_TRACE_RTOL and k[-1] < k[PN_TRACE_STEPS - 1 - n],
             "the PerturbNet's Adam trace departs from the plain one or does not fall")


def phase_k1_trace(P: int, dims) -> None:
    """K1_TRACE_STEPS Adam steps (lr 1e-4, the mean fit's) at P rows of the
    flagship's widths from one init, K1 on its tensor-core route against
    the plain K1 on the card; the losses step by step. The plain K1 in
    float64 runs the same steps for the record: the float32 plain K1's gap
    to it says how far the fit itself spreads float32 rounding."""
    import torch

    from mri_super_resolution_tpu_torch.fit.optim import Adam
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    x, ws, target, _ = _flagship_inputs(P, dims, seed=3)
    traces = {}
    for route, vag, dtype in (("kernel", sk.siren_loss_grads, torch.float32),
                              ("plain", sk.siren_loss_grads_ref, torch.float32),
                              ("float64", sk.siren_loss_grads_ref, torch.float64)):
        params = [w.to(dtype, copy=True) for w in ws]
        opt = Adam(params, 1e-4)
        losses = []
        for _ in range(K1_TRACE_STEPS):
            loss, grads = vag(x.to(dtype), params, target.to(dtype))
            losses.append(loss.double())
            opt.step(grads)
        traces[route] = torch.stack(losses).tolist()

    def step_rel(a, b):
        return [abs(u / v - 1.0) for u, v in zip(traces[a], traces[b])]

    by_step = step_rel("kernel", "plain")
    rel = max(by_step)
    k, p = traces["kernel"], traces["plain"]
    print(f"[parity] K1 {K1_TRACE_STEPS}-step Adam trace at P={P}, tensor-core route "
          f"vs plain: loss {p[0]:.6e} -> {p[-1]:.6e} (plain), {k[-1]:.6e} (kernel); worst "
          f"step rel {rel:.3e} (tol {K1_TRACE_RTOL:g}); against the plain K1 in float64: "
          f"kernel {max(step_rel('kernel', 'float64')):.3e}, plain float32 "
          f"{max(step_rel('plain', 'float64')):.3e}; kernel vs plain by step "
          f"{', '.join(f'{r:.1e}' for r in by_step)}")
    _require(rel <= K1_TRACE_RTOL and k[-1] < k[0], "K1's Adam trace departs from the plain one")


def phase_k1_hybrid_parity(P: int, dims) -> dict:
    """K1 on its tensor-core route at the hybrid fit's P rows (ragged
    against the 128-row tile) against the plain K1, twice for the same
    bits; returns its max abs error."""
    import torch

    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    x, ws, target, _ = _flagship_inputs(P, dims, seed=5)
    before = sk.LAUNCHES["siren_loss_grads_wg"]
    loss, grads = sk.siren_loss_grads(x, ws, target)
    loss2, grads2 = sk.siren_loss_grads(x, ws, target)
    loss_r, grads_r = sk.siren_loss_grads_ref(x, ws, target)
    torch.cuda.synchronize()
    _require(sk.LAUNCHES["siren_loss_grads_wg"] == before + 2,
             "K1 at the hybrid's shape did not take the tensor-core route")
    worst = _worst_rel([(loss, loss_r), *zip(grads, grads_r)])
    print(f"[parity] K1 siren_loss_grads at the hybrid's P={P} ({P % sk.TC_TILE} rows in "
          f"the last tile), tensor-core route: worst over loss/dW/db max abs {worst[0]:.3e}, "
          f"rel {worst[1]:.3e} (tol rel {K1_K2_TOL:g})")
    _require(worst[1] <= K1_K2_TOL, "K1 at the hybrid's shape disagrees with its plain version")
    _require(torch.equal(loss, loss2) and all(torch.equal(a, b) for a, b in zip(grads, grads2)),
             "two tensor-core K1 calls at the hybrid's shape differ")
    return {"siren_loss_grads_wg_hybrid": worst[0]}


def _stacked_inputs(P: int, dims, D: int, seed: int):
    """D seeded problems of :func:`_flagship_inputs`' scale on one x: x, the
    stacked weights (each W (D, out, in), b (D, out)) and targets (D, P,
    1)."""
    import torch

    probs = [_flagship_inputs(P, dims, seed + s) for s in range(D)]
    ws = [torch.stack([p[1][i] for p in probs]) for i in range(len(probs[0][1]))]
    return probs[0][0], ws, torch.stack([p[2] for p in probs])


def _batched_check(what: str, got, ref, singles, again, stash_ref=None) -> float:
    """Hold a batched K1's (loss (D,), grads) against its plain batched
    version and against D unbatched kernel calls, slot by slot, at
    K1_K2_TOL, and two calls for the same bits; with ``stash_ref`` (the plain
    version with the kernel's own bf16 stash) also against that at
    K1_WG_STASH_TOL. Returns the max abs error against the kernel's own
    plain version (``stash_ref`` when given)."""
    import torch

    D = got[0].shape[0]
    worst_ref, worst_one, worst_stash, same = (0.0, 0.0), (0.0, 0.0), (0.0, 0.0), True
    for s in range(D):
        pairs = [(got[0][s], ref[0][s]), *((a[s], b[s]) for a, b in zip(got[1], ref[1]))]
        worst_ref = max(worst_ref, _worst_rel(pairs))
        if stash_ref is not None:
            worst_stash = max(worst_stash, _worst_rel(
                [(got[0][s], stash_ref[0][s]),
                 *((a[s], b[s]) for a, b in zip(got[1], stash_ref[1]))]))
        one = [(got[0][s], singles[s][0]), *((a[s], b) for a, b in zip(got[1], singles[s][1]))]
        worst_one = max(worst_one, _worst_rel(one))
        same = same and all(torch.equal(a, b) for a, b in one)
    stash = ("" if stash_ref is None else
             f"against the plain version with its bf16 stash max abs {worst_stash[0]:.3e}, rel "
             f"{worst_stash[1]:.3e} (tol rel {K1_WG_STASH_TOL:g}); ")
    print(f"[parity] {what}: {stash}against the plain batched version (float32) worst over "
          f"loss/dW/db max abs {worst_ref[0]:.3e}, rel {worst_ref[1]:.3e}; against {D} unbatched "
          f"kernel calls max abs {worst_one[0]:.3e}, rel {worst_one[1]:.3e} (tol rel "
          f"{K1_K2_TOL:g}); every slot bit-equal to its unbatched call: {same}")
    if stash_ref is not None:
        _require(worst_stash[1] <= K1_WG_STASH_TOL,
                 f"{what} disagrees with its plain batched version with the bf16 stash")
    _require(worst_ref[1] <= K1_K2_TOL, f"{what} disagrees with its plain batched version")
    _require(worst_one[1] <= K1_K2_TOL, f"{what} disagrees with {D} unbatched calls")
    _require(torch.equal(got[0], again[0])
             and all(torch.equal(a, b) for a, b in zip(got[1], again[1])),
             f"two calls of {what} differ")
    return (worst_ref if stash_ref is None else worst_stash)[0]


def phase_k1_batched_parity(P: int, dims) -> dict:
    """The batched K1 of the tensor-core class at the hybrid fit's shape,
    D = 4 stacked 256 -> 512x4 -> 1 SIRENs on P = 100,800 rows (one call of
    csrc/siren_wg.cu's siren_loss_grads_wg), against its plain batched
    version with the bf16 stash (K1_WG_STASH_TOL), the float32 one and four
    unbatched tensor-core K1 calls (K1_K2_TOL), twice for the same bits;
    returns its max abs error against the bf16-stash plain version."""
    import torch

    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    x, ws, target = _stacked_inputs(P, dims, HYBRID_TES, seed=61)
    before = dict(sk.LAUNCHES)
    got = sk.siren_loss_grads_batched(x, ws, target)
    again = sk.siren_loss_grads_batched(x, ws, target)
    singles = [sk.siren_loss_grads(x, [w[s] for w in ws], target[s]) for s in range(HYBRID_TES)]
    torch.cuda.synchronize()
    key = "siren_loss_grads_wg_batched"
    _require(sk.LAUNCHES == {**before, key: before[key] + 2,
                             "siren_loss_grads_wg": before["siren_loss_grads_wg"] + HYBRID_TES},
             "the batched K1 did not take its wgmma kernel")
    ref = sk.siren_loss_grads_batched_ref(x, ws, target)
    stash_ref = sk.siren_loss_grads_batched_ref(x, ws, target, stash="bf16")
    err = _batched_check(f"K1 batched x{HYBRID_TES} at the hybrid's P={P}, csrc/siren_wg.cu",
                         got, ref, singles, again, stash_ref)
    return {"siren_loss_grads_wg_batched": err}


def phase_k1w_batched_parity() -> dict:
    """The batched K1-w (``csrc/siren_resident_tc.cu``) at the 2-D
    ensemble's shape, D = 3 stacked 2 -> 64x7 -> 1 Sirens on P = 3,600 rows
    with sample weights, held as the parameter buffer of a ``StackedAdam``
    holds them: slot 2 a padded acquisition slot (every weight 0: its loss
    and grads exactly 0), all rows and a ragged count, against its plain
    batched version and three unbatched K1-w calls (the streaming route),
    twice for the same bits; one call captured in a CUDA graph and
    replayed, the same bits as an eager call; and a K1_TRACE_STEPS-step
    stacked Adam fit (lr 3e-4, the ensemble's) from one init against the
    plain batched version, loss by loss. Returns its max abs error."""
    import torch

    from mri_super_resolution_tpu_torch.fit.optim import StackedAdam
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    models, x, targets, sws = zip(*(_master_inputs(seed=71 + d) for d in range(MASTER_DIRS)))
    x, acts = x[0], models[0].acts
    ws0 = [torch.stack(t) for t in zip(*(m.weights() for m in models))]
    ws = StackedAdam(ws0, 3e-4).params
    target, sw = torch.stack(targets), torch.stack(sws)
    padded = sw.clone()
    padded[MASTER_DIRS - 1] = 0.0
    key, one = "siren_loss_grads_weighted_resident_tc_batched", "siren_loss_grads_weighted_stream"
    err = 0.0
    for n_rows in (MASTER_P, MASTER_P - 123):
        before = dict(sk.LAUNCHES)
        kw = dict(n_rows=n_rows, acts=acts, sample_weights=padded)
        got = sk.siren_loss_grads_batched(x, ws, target, **kw)
        again = sk.siren_loss_grads_batched(x, ws, target, **kw)
        singles = [sk.siren_loss_grads(x, [w[s] for w in ws], target[s], n_rows=n_rows,
                                       acts=acts, sample_weights=padded[s])
                   for s in range(MASTER_DIRS)]
        torch.cuda.synchronize()
        _require(sk.LAUNCHES == {**before, key: before[key] + 2, one: before[one] + MASTER_DIRS},
                 "the batched K1-w did not take its kernel (csrc/siren_resident_tc.cu)")
        ref = sk.siren_loss_grads_batched_ref(x, ws, target, 30.0, n_rows, acts, padded)
        e = _batched_check(f"K1-w batched x{MASTER_DIRS} P={MASTER_P} n_rows={n_rows}, "
                           f"csrc/siren_resident_tc.cu, slot {MASTER_DIRS - 1} padded",
                           got, ref, singles, again)
        _require(float(got[0][-1]) == 0.0 and all(float(g[-1].abs().max()) == 0.0
                                                  for g in got[1]),
                 "the padded slot's loss or grads are not exactly 0")
        err = max(err, e)

    call = lambda: sk.siren_loss_grads_batched(x, ws, target, acts=acts, sample_weights=sw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_loss, g_grads = call()
    graph.replay()
    graph.replay()
    e_loss, e_grads = call()
    torch.cuda.synchronize()
    same = torch.equal(g_loss, e_loss) and all(torch.equal(a, b) for a, b in zip(g_grads, e_grads))
    print(f"[parity] K1-w batched x{MASTER_DIRS}: one call captured in a CUDA graph, replayed "
          f"twice, bit-equal to an eager call: {same}")
    _require(same, "the batched K1-w replayed from a CUDA graph differs from an eager call")

    traces = {}
    for route, vag in (("kernel", sk.siren_loss_grads_batched),
                       ("plain", sk.siren_loss_grads_batched_ref)):
        opt = StackedAdam(ws0, 3e-4)
        losses = []
        for _ in range(K1_TRACE_STEPS):
            loss, grads = vag(x, opt.params, target, 30.0, None, acts, sw)
            losses.append(loss)
            opt.step(grads)
        traces[route] = torch.stack(losses)
    k, p = traces["kernel"], traces["plain"]
    rel = float((k / p - 1.0).abs().max())
    print(f"[parity] K1-w batched x{MASTER_DIRS} {K1_TRACE_STEPS}-step stacked Adam trace (lr "
          f"3e-4) at 2 -> 64x7 -> 1, P={MASTER_P}: loss {p[0].tolist()} -> {p[-1].tolist()} "
          f"(plain), {k[-1].tolist()} (kernel); worst step and slot rel {rel:.3e} (tol "
          f"{K1_TRACE_RTOL:g})")
    _require(rel <= K1_TRACE_RTOL and bool((k[-1] < k[0]).all()),
             "the batched K1-w's Adam trace departs from the plain one")
    return {key: err}


def phase_k4_trace(P: int) -> None:
    """K1_TRACE_STEPS Adam steps (lr K4_TRACE_LR, the WIRE fit's) at the
    WIRE path's 4 -> 256x2 -> 1 on P rows from one init, K4 on its
    tensor-core route against the plain K4 on the card; the losses step by
    step."""
    import torch

    from mri_super_resolution_tpu_torch.fit.optim import Adam
    from mri_super_resolution_tpu_torch.ops import wire_kernel as wk

    model, x, target = _wire_inputs(P, 256, 2, seed=5)
    ws, _, oms = wk.split_params(model.params(), 2)
    traces = {}
    before = wk.LAUNCHES["wire_loss_grads_tc"]
    for route, vag in (("kernel", wk.wire_loss_grads), ("plain", wk.wire_loss_grads_ref)):
        params = [w.detach().clone() for w in ws]
        opt = Adam(params, K4_TRACE_LR)
        losses = []
        for _ in range(K1_TRACE_STEPS):
            loss, grads = vag(x, params, oms, target)
            losses.append(loss)
            opt.step(grads)
        traces[route] = torch.stack(losses).tolist()
    _require(wk.LAUNCHES["wire_loss_grads_tc"] == before + K1_TRACE_STEPS,
             "the K4 trace did not run on the tensor-core route")
    k, p = traces["kernel"], traces["plain"]
    rel = max(abs(a / b - 1.0) for a, b in zip(k, p))
    print(f"[parity] K4 {K1_TRACE_STEPS}-step Adam trace (lr {K4_TRACE_LR:g}) at 4 -> 256x2 "
          f"-> 1, tensor-core route vs plain: loss {p[0]:.6e} -> {p[-1]:.6e} (plain), "
          f"{k[-1]:.6e} (kernel); worst step rel {rel:.3e} (tol {K1_TRACE_RTOL:g})")
    _require(rel <= K1_TRACE_RTOL and k[-1] < k[0], "K4's Adam trace departs from the plain one")


def _master_inputs(seed: int):
    """The 2-D ensemble's K1 call on the card: a seeded Siren(2 -> 64x6) at
    its init, the 60 x 60 ROI grid, a target in Normalize(0.5, 0.5) space
    and acceptance weights with one row in ten rejected."""
    import torch

    from mri_super_resolution_tpu_torch.core.coords import mgrid
    from mri_super_resolution_tpu_torch.models import Siren

    gen = torch.Generator().manual_seed(seed)
    model = Siren(2, MASTER_HIDDEN, MASTER_LAYERS, generator=gen).cuda()
    model.requires_grad_(False)
    x = mgrid((60, 60), device="cuda")
    target = (torch.rand(MASTER_P, 1, generator=gen) * 2 - 1).cuda()
    sw = (torch.rand(MASTER_P, 1, generator=gen) > 0.1).float().cuda()
    return model, x, target, sw


def _erd_inputs(seed: int, last_bias: float | None = None, side: int = ERD_SIDE):
    """The soft-ERD fit's K1 call on the card: a seeded SirenERD(2 -> 128x3,
    ReLU head) at its init (``last_bias`` overrides the output bias), the
    ``side`` x ``side`` grid (128 x 128, the half-res harness's LR slice 64 x
    64) and a target in [0, 1]."""
    import torch

    from mri_super_resolution_tpu_torch.core.coords import mgrid
    from mri_super_resolution_tpu_torch.models import SirenERD

    gen = torch.Generator().manual_seed(seed)
    model = SirenERD(2, ERD_HIDDEN, ERD_LAYERS, perturb=True, generator=gen).cuda()
    model.requires_grad_(False)
    if last_bias is not None:
        model.final.bias.fill_(last_bias)
    x = mgrid((side, side), device="cuda")
    target = torch.rand(side * side, 1, generator=gen).cuda()
    return model, x, target


def phase_k1_variant_parity() -> dict:
    """K1's weighted variant at the 2-D ensemble's shape and its absmax/ReLU
    variant at the soft-ERD fit's, each with all rows and a ragged count,
    and a collapsed ReLU output (max |out| 0 and every gradient 0 exactly,
    on the card too); K3 and K2 once with the ReLU codes. Returns max abs
    errors by variant."""
    import torch

    from mri_super_resolution_tpu_torch.ops import _build
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    errs = {}
    model, x, target, sw = _master_inputs(seed=31)
    ws, acts = model.weights(), model.acts
    dims = (2,) + (MASTER_HIDDEN,) * (MASTER_LAYERS + 1) + (1,)
    _require(sk.k1_route(dims, acts, True) == "stream",
             "the 2-D ensemble's K1 is not of the streaming route's class")
    worst_all = (0.0, 0.0)
    for n_rows in (MASTER_P, MASTER_P - 123):
        before = dict(sk.LAUNCHES)
        loss, grads = sk.siren_loss_grads(x, ws, target, acts=acts, n_rows=n_rows,
                                          sample_weights=sw)
        again = sk.siren_loss_grads(x, ws, target, acts=acts, n_rows=n_rows, sample_weights=sw)
        simt = sk._launch_loss_grads(sk._lib(), x, ws, target, 30.0, n_rows,
                                     _build.stream_ptr(), acts, sw)
        loss_r, grads_r = sk.siren_loss_grads_ref(x, ws, target, 30.0, n_rows, acts, sw)
        torch.cuda.synchronize()
        _require(sk.LAUNCHES == {**before, "siren_loss_grads_weighted_stream":
                                 before["siren_loss_grads_weighted_stream"] + 2},
                 "K1-w did not take the streaming route")
        worst = _worst_rel([(loss, loss_r), *zip(grads, grads_r)])
        r_simt = _worst_rel([(simt[0], loss_r), *zip(simt[1], grads_r)])[1]
        print(f"[parity] K1 weighted P={MASTER_P} n_rows={n_rows}, streaming route: loss "
              f"{float(loss):.6e} vs {float(loss_r):.6e}; worst over loss/dW max abs "
              f"{worst[0]:.3e}, rel {worst[1]:.3e} (tol rel {K1_K2_TOL:g}); SIMT (csrc/siren.cu) "
              f"rel {r_simt:.3e}")
        _require(worst[1] <= K1_K2_TOL, "K1 weighted disagrees with its plain version")
        _require(r_simt <= K1_K2_TOL,
                 "the SIMT K1-w (csrc/siren.cu) disagrees with its plain version")
        _require(torch.equal(loss, again[0])
                 and all(torch.equal(a, b) for a, b in zip(grads, again[1])),
                 "two streaming K1-w calls differ: the slots are not summed in a fixed order")
        worst_all = max(worst_all, worst)
    errs["siren_loss_grads_weighted_stream"] = worst_all[0]

    worst_all = (0.0, 0.0)
    P = ERD_SIDE * ERD_SIDE
    dims = (2,) + (ERD_HIDDEN,) * (ERD_LAYERS + 2) + (1,)
    gen = torch.Generator().manual_seed(34)
    sw = (torch.rand(P, 1, generator=gen) > 0.1).float().cuda()
    for bias, n_rows, weights in ((0.05, P, None), (0.05, P - 1234, None), (0.05, P, sw),
                                  (0.05, P - 1234, sw), (-10.0, P, None), (-10.0, P, sw)):
        model, x, target = _erd_inputs(seed=32, last_bias=bias)
        ws, acts = model.weights(), model.acts
        _require(sk.k1_route(dims, acts, weights is not None, True) == "stream",
                 "K1-a is not of the streaming route's class")
        key = sk.loss_grads_key(weights is not None, True, "stream")
        before = dict(sk.LAUNCHES)
        got = sk.siren_loss_grads(x, ws, target, acts=acts, n_rows=n_rows,
                                  sample_weights=weights, with_out_absmax=True)
        again = sk.siren_loss_grads(x, ws, target, acts=acts, n_rows=n_rows,
                                    sample_weights=weights, with_out_absmax=True)
        _require(sk.LAUNCHES == {**before, key: before[key] + 2},
                 "K1-a did not take the streaming route")
        simt = sk._launch_loss_grads(sk._lib(), x, ws, target, 30.0, n_rows,
                                     _build.stream_ptr(), acts, weights, True)
        loss_r, am_r, grads_r = sk.siren_loss_grads_ref(x, ws, target, 30.0, n_rows, acts,
                                                        weights, True)
        torch.cuda.synchronize()
        loss, am, grads = got
        worst = _worst_rel([(loss, loss_r), *zip(grads, grads_r)])
        loss_rel, am_rel = _rel(loss, loss_r)[1], _rel(am, am_r)[1]
        r_simt = _worst_rel([(simt[0], loss_r), *zip(simt[2], grads_r)])[1]
        print(f"[parity] K1 absmax/ReLU P={P} n_rows={n_rows} last bias {bias:g} "
              f"{'weighted' if weights is not None else 'unweighted'}, streaming route: loss "
              f"{float(loss):.6e} vs {float(loss_r):.6e} (rel {loss_rel:.2e}, tol "
              f"{K1A_LOSS_RTOL:g}); max |out| {float(am):.6e} vs {float(am_r):.6e} (rel "
              f"{am_rel:.2e}, tol {K1_ABSMAX_TOL:g}); worst over loss/dW max abs "
              f"{worst[0]:.3e}, rel {worst[1]:.3e} (tol rel {K1_K2_TOL:g}); SIMT "
              f"(csrc/siren.cu) rel {r_simt:.3e}, max |out| {float(simt[1]):.6e}")
        _require(all(torch.equal(a, b) for a, b in zip([loss, am, *grads],
                                                        [again[0], again[1], *again[2]])),
                 "two streaming K1-a calls differ: the slots are not summed in a fixed order")
        if bias < 0:
            _require(float(am) == 0.0 and all(float(g.abs().max()) == 0.0 for g in grads)
                     and float(simt[1]) == 0.0,
                     "a collapsed output must give max |out| 0 and zero gradients")
        else:
            _require(worst[1] <= K1_K2_TOL and am_rel <= K1_ABSMAX_TOL
                     and loss_rel <= K1A_LOSS_RTOL,
                     "K1 absmax disagrees with its plain version")
            _require(r_simt <= K1_K2_TOL,
                     "the SIMT K1-a (csrc/siren.cu) disagrees with its plain version")
            worst_all = max(worst_all, worst, (float((am - am_r).abs()), am_rel))
    errs["siren_loss_grads_absmax_stream"] = worst_all[0]

    # the SIMT K3 and K2 (csrc/siren.cu), which every call off the
    # tensor-core route's class takes
    model, x, target = _erd_inputs(seed=33, last_bias=0.05)
    ws, acts = model.weights(), model.acts
    before = dict(sk.LAUNCHES)
    e, r = _rel(sk.siren_forward(x, ws, acts=acts), sk.siren_forward_ref(x, ws, acts=acts))
    g = (target - 0.5) / P
    dx, dws = sk.siren_fused_bwd(x, ws, g, acts=acts)
    dx_r, dws_r = sk.siren_fused_bwd_ref(x, ws, g, acts=acts)
    torch.cuda.synchronize()
    worst = _worst_rel([(dx, dx_r), *zip(dws, dws_r)])
    print(f"[parity] SIMT K3 with ReLU codes P={P}: rel {r:.3e} (tol {K3_TOL:g}); SIMT K2 "
          f"with ReLU codes: worst over dx/dW rel {worst[1]:.3e} (tol {K1_K2_TOL:g})")
    _require(r <= K3_TOL and worst[1] <= K1_K2_TOL, "K2/K3 with ReLU codes disagree")
    _require(sk.LAUNCHES["siren_forward"] == before["siren_forward"] + 1
             and sk.LAUNCHES["siren_fused_bwd"] == before["siren_fused_bwd"] + 1,
             "K2/K3 with ReLU codes did not take the SIMT kernels")
    return errs


def _probe_operands(dtype, grid_rows: int = PROBE_REPS):
    import torch

    from mri_super_resolution_tpu_torch.cli.int8_mma_probe import operands

    a, b = operands(dtype, PROBE_T, PROBE_H, grid_rows)
    a, b = a.cuda(), b.cuda()
    return a, b, b.t().contiguous()


def phase_probe_parity() -> dict:
    """P1 against its plain version on the card at one step of its full
    shape (T 384, H 512, REPS 8): int8 bit for bit (exact int32 step sums,
    one rounding), bf16 within PROBE_BF16_TOL of the largest output; and at
    3 steps (several blocks' partials added). Returns max abs errors."""
    import torch

    from mri_super_resolution_tpu_torch.ops import mma_probe as mp

    errs = {}
    for dtype, key in ((torch.int8, "mma_probe_int8"), (torch.bfloat16, "mma_probe_bf16")):
        a, b, bt = _probe_operands(dtype)
        err = 0.0
        for grid in (1, 3):
            out = mp.mma_probe(a, b, PROBE_REPS, grid, bt)
            ref = mp.mma_probe_ref(a, b, PROBE_REPS, grid)
            torch.cuda.synchronize()
            e, r = _rel(out, ref)
            print(f"[parity] P1 {key} GRID={grid}: max abs {e:.3e}, rel {r:.3e}, max |plain| "
                  f"{float(ref.abs().max()):.3e} (tol: "
                  f"{'exact' if dtype == torch.int8 else f'rel {PROBE_BF16_TOL:g}'})")
            if dtype == torch.int8:
                _require(torch.equal(out, ref), f"P1 int8 differs from its plain version "
                         f"(GRID {grid})")
            else:
                _require(r <= PROBE_BF16_TOL, f"P1 bf16 disagrees (GRID {grid})")
            err = max(err, e)
        errs[key] = err
    return errs


def phase_small_2d() -> None:
    """A small 2-D ensemble case (Siren 64x1, 6 steps, AutoERD) and a small
    soft-ERD phase 1 (SirenERD 16x1, 30 steps, threshold 0) on the card's
    K1 variants against the plain path on the CPU, from the same init."""
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch.config import Master2DConfig
    from mri_super_resolution_tpu_torch.core.coords import mgrid
    from mri_super_resolution_tpu_torch.fit.engine import fit_until, plain_apply_init
    from mri_super_resolution_tpu_torch.models import SirenERD
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk
    from mri_super_resolution_tpu_torch.pipelines import master2d

    cfg = Master2DConfig(total_steps=6, seg=2, hidden_layers=1, hidden_features=64,
                         roi_begin=8, roi_end=24, scale=2, erd=1)
    outs = {}
    for dev in ("cuda", "cpu"):
        case = _misr_case(seed=3, side=32, slices=4)  # 27 acquisitions (9, 9, 9)
        case.cancer_slice = 1
        sk.reset_launches()
        outs[dev] = master2d.run_case(case, cfg, 0, device=dev)
        if dev == "cuda":
            launches = dict(sk.LAUNCHES)
    err = max(float(np.abs(outs["cuda"][d].superres - outs["cpu"][d].superres).max())
              for d in outs["cpu"])
    batched = launches["siren_loss_grads_weighted_resident_tc_batched"]
    print(f"[parity] small 2-D ensemble case, card batched K1-weighted "
          f"(csrc/siren_resident_tc.cu, the three directions a launch) vs CPU plain: superres "
          f"max abs {err:.3e} (tol {E2E_ATOL:g}); "
          f"batched K1-weighted launches {batched}")
    _require(err <= E2E_ATOL and batched == 6 * MASTER_SLOTS
             and sum(launches.values()) == batched, "small 2-D ensemble case disagrees")

    runs = {}
    target = torch.rand(24 * 24, 1, generator=torch.Generator().manual_seed(4)) * 0.5 + 0.2
    for dev in ("cuda", "cpu"):
        model = SirenERD(2, 16, 1, perturb=True, device=dev)
        apply_fn, init_fn = plain_apply_init(model, torch.Generator().manual_seed(5))
        runs[dev] = fit_until(apply_fn, 3e-3, init_fn, mgrid((24, 24), device=dev),
                              target.to(dev), 0.0, 30, sk.make_fused_value_grad_absmax(model))
    lg, lc = np.asarray(runs["cuda"].losses), np.asarray(runs["cpu"].losses)
    print(f"[parity] small soft-ERD phase 1 (30 steps), card K1-absmax vs CPU plain: loss "
          f"{lc[0]:.4e} -> {lc[-1]:.4e}, max rel {float(np.abs(lg / lc - 1).max()):.3e} "
          f"(tol 1e-4); restarts {runs['cuda'].restarts} vs {runs['cpu'].restarts}")
    _require(bool(np.allclose(lg, lc, rtol=1e-4, atol=0))
             and runs["cuda"].restarts == runs["cpu"].restarts,
             "small soft-ERD phase 1 disagrees")


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


def _k6_check(out, ref, what: str, kernel: str = "K6 conv3d_rfab") -> float:
    """Hold K6 (or K7's dx) against its plain version: float32 within
    K6_F32_TOL of the largest output; bf16 within K6_BF16_ULPS bf16 ulps of
    each output plus the float32 order term. Returns the max abs error."""
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
    print(f"[parity] {kernel} {what}: max abs {err:.3e}, max |plain| {scale:.3e} "
          f"(tol {tol})")
    _require(ok, f"{kernel} disagrees with its plain version ({what})")
    return err


def _k6_routes(x, w, b, pad: str, what: str) -> float:
    """bf16 K6 at C = Cout = 32 (the wgmma kernel, through the wrapper)
    against the mma.sync kernel ``conv3d_tc_kernel`` on the same call: the
    share of outputs bit-equal, and two wrapper calls the same bits.
    Returns the share."""
    import torch

    from mri_super_resolution_tpu_torch.ops import _build
    from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck

    lib = ck._lib()
    before = dict(ck.LAUNCHES)
    got = ck.conv3d_rfab(x, w, b, pad)
    again = ck.conv3d_rfab(x, w, b, pad)
    _require(ck.LAUNCHES["conv3d_rfab_wg"] - before["conv3d_rfab_wg"] == 2,
             f"K6 {what}: the calls did not take the wgmma kernel")
    sync = ck._launch(lib, x, w.to(x.dtype), b, pad, _build.stream_ptr(),
                      fn=lib.conv3d_rfab_bf16)
    share = float((got == sync).float().mean())
    print(f"[parity] K6 {what}: wgmma vs mma.sync kernel bit-equal in {share:.6f} of the "
          f"outputs, max abs gap {float((got.float() - sync.float()).abs().max()):.3e}; two "
          f"calls the same bits: {torch.equal(got, again)}")
    _require(torch.equal(got, again), f"K6 gave other bits on a second call ({what})")
    return share


def phase_k6_parity() -> float:
    """K6 against its plain version at the seven MISR path shapes in bf16
    and float32, at the seven training path shapes in bf16, and on ragged
    shapes (B 1, H != W, odd sizes, C 8 and 16, SAME and VALID); every bf16
    call of the two paths (C = Cout = 32) on the wgmma kernel, also held to
    the mma.sync kernel ``conv3d_tc_kernel`` (the share of bit-equal
    outputs) and repeated for the same bits. Returns the max abs error over the serving path's bf16
    calls."""
    import torch

    from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck

    err = 0.0
    shares = []
    with torch.no_grad():
        for i, (shape, pad, _) in enumerate(K6_SHAPES):
            for dtype in (torch.bfloat16, torch.float32):
                x, w, b = _k6_inputs(shape, dtype, seed=i)
                what = f"{shape} {pad} {str(dtype)[6:]}"
                e = _k6_check(ck.conv3d_rfab(x, w, b, pad), ck.conv3d_rfab_ref(x, w, b, pad),
                              what)
                if dtype == torch.bfloat16:
                    err = max(err, e)
                    shares.append(_k6_routes(x, w, b, pad, what))
                del x
        for i, (shape, pad, _) in enumerate(TRAIN_SHAPES):
            x, w, b = _k6_inputs(shape, torch.bfloat16, seed=50 + i)
            what = f"{shape} {pad} bfloat16 (training)"
            _k6_check(ck.conv3d_rfab(x, w, b, pad), ck.conv3d_rfab_ref(x, w, b, pad), what)
            shares.append(_k6_routes(x, w, b, pad, what))
            del x
        print(f"[parity] K6 wgmma vs mma.sync kernel over the 14 path shapes: bit-equal in "
              f"{min(shares):.6f}-{max(shares):.6f} of the outputs")
        for shape, pad in (((1, 37, 21, 5, 8), "SAME"), ((1, 19, 45, 7, 16), "VALID"),
                           ((1, 3, 5, 3, 16), "VALID")):
            for dtype in (torch.bfloat16, torch.float32):
                x, w, b = _k6_inputs(shape, dtype, seed=sum(shape))
                _k6_check(ck.conv3d_rfab(x, w, b, pad), ck.conv3d_rfab_ref(x, w, b, pad),
                          f"{shape} {pad} {str(dtype)[6:]}")
    torch.cuda.empty_cache()
    return err


def _g1_problem(shape, dtype, seed: int):
    """An RFAB's gate modules (seeded, biases off 0.5) and a seeded x and res
    of ``shape`` in ``dtype`` on the card; the gate's effective weights as
    G1 takes them."""
    import torch

    from mri_super_resolution_tpu_torch.models.rams import RFAB

    gen = torch.Generator().manual_seed(seed)
    C = shape[-1]
    blk = RFAB(C, r=8 if C >= 16 else 4)
    for conv in (blk.att0, blk.att1):
        conv.reset_parameters(gen)
        with torch.no_grad():
            conv.bias.uniform_(-1.0, 1.0, generator=gen)
    blk = blk.cuda().requires_grad_(False)
    x = (torch.randn(shape, generator=gen) + 0.25).to("cuda", dtype)
    res = torch.randn(shape, generator=gen).to("cuda", dtype)
    return blk, x, res, blk.gate_weights()


def _g1_check(shape, dtype, seed: int) -> float:
    """G1 against the eager chain at one shape: both gates (G1's from its
    sum and gate passes) within one bf16 ulp (16 float32 ulps) and equal in
    over half the (item, channel) pairs, G1's output bit for bit the eager
    chain's wherever the gates agree, its apply pass given the eager gate bit
    for bit the eager output everywhere, and two calls the same bits.
    Returns the max abs gap of the outputs."""
    import torch

    from mri_super_resolution_tpu_torch.ops import _build
    from mri_super_resolution_tpu_torch.ops import rams_gate as rg

    blk, x, res, weights = _g1_problem(shape, dtype, seed)
    B, C = shape[0], shape[-1]
    with torch.inference_mode():
        fused = rg.rfab_gate(x, res, *weights)
        again = rg.rfab_gate(x, res, *weights)
        eager = blk.gate_eager(x, res)
        att_e = torch.sigmoid(blk.att1(torch.relu(blk.att0(
            x.float().mean(dim=(1, 2, 3), keepdim=True))))).to(dtype).reshape(B, C)
        x3 = x.reshape(B, -1, C)
        work = torch.empty(rg.work_floats(*x3.shape), device="cuda")
        att_f = torch.empty(B, C, dtype=dtype, device="cuda")
        rg._launch_att(rg._lib(), x3, *weights, work, att_f, rg.SLOT_PIXELS,
                       _build.stream_ptr())
        given = torch.empty_like(x3)
        rg._launch_apply(rg._lib(), x3, att_e, res.reshape(B, -1, C), given,
                         _build.stream_ptr())
    # bf16: the float32 gates round to one bf16 value or to neighbours;
    # float32: 16 ulps, about 1e-6 relative (the mean's order, the MLP's fmaf)
    bits, ulps = (8, 1.0) if dtype == torch.bfloat16 else (24, 16.0)
    ulp = 2.0 ** (torch.floor(torch.log2(att_e.float().abs())) - (bits - 1))
    gate_gap = float(((att_f.float() - att_e.float()).abs() / ulp).max())
    agree = (att_f == att_e).reshape(B, *(1,) * (len(shape) - 2), C).expand(shape)
    share = float((att_f == att_e).float().mean())
    err = float((fused.float() - eager.float()).abs().max())
    print(f"[parity] G1 rfab_gate {shape} {str(dtype)[6:]}: gates agree in "
          f"{share:.4f} of (item, channel), at most {gate_gap:.1f} ulp apart; output max abs "
          f"gap {err:.3e}")
    _require(gate_gap <= ulps, f"G1's gate {gate_gap} ulp from the eager chain's ({shape})")
    _require(share > 0.5, f"G1's gate equals the eager chain's in only {share:.4f} ({shape})")
    _require(torch.equal(given.reshape(shape), eager),
             f"G1's apply pass given the eager gate differs from the eager output ({shape})")
    _require(torch.equal(fused[agree], eager[agree]),
             f"G1's output differs from the eager chain's where the gates agree ({shape})")
    _require(torch.equal(fused, again), f"G1 gave other bits on a second call ({shape})")
    return err


def phase_g1_parity() -> float:
    """G1 against the eager chain at the four RFAB shapes of the MISR path
    in bf16, and in float32 and at C 8 and 12 on ragged shapes; one fused
    launch a call. Returns the max abs output gap over the path's bf16 calls."""
    import torch

    from mri_super_resolution_tpu_torch.ops import rams_gate as rg

    rg.reset_launches()
    err = max(_g1_check(shape, torch.bfloat16, seed=i) for i, (shape, _) in enumerate(G1_SHAPES))
    ragged = ((3, 37, 21, 5, 32), (2, 19, 45, 7, 8), (2, 19, 45, 7, 12))  # C 12: an element a load
    for shape in ragged:
        for dtype in (torch.bfloat16, torch.float32):
            _g1_check(shape, dtype, seed=sum(shape))
    calls = len(G1_SHAPES) + 2 * len(ragged)
    _require(rg.LAUNCHES == {"rfab_gate": 2 * calls, "rfab_gate_eager": calls},
             f"G1 launches {rg.LAUNCHES}")
    torch.cuda.empty_cache()
    return err


def _b0_blob(seed: int, side: int = 128, slices: int = 24):
    """A seeded smooth blob of about 100 on a floor of 90, (side, side,
    slices) float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x, y, z = np.meshgrid(np.linspace(-1, 1, side), np.linspace(-1, 1, side),
                          np.linspace(-1, 1, slices), indexing="ij")
    return (100.0 * np.exp(-(x ** 2 / 0.5 + y ** 2 / 0.3 + z ** 2)) + 90.0
            + 5.0 * rng.random((side, side, slices))).astype(np.float32)


def _misr_case(seed: int, side: int = 128, slices: int = 24):
    """A seeded synthetic case: b0 (side, side, slices) at DWI magnitudes
    (a smooth blob of about 100 on a floor of 90: after the b = 900 decay
    and x256 the slice's mean lands near the PROBA-V mean of 7433), 27
    acquisitions (9, 9, 9) from ``acquisitions_from_b0``, cancer slice 12."""
    import numpy as np

    from mri_super_resolution_tpu_torch.data import Case, synthetic

    b0 = _b0_blob(seed, side, slices)
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
    """misr.run() with each case's outputs, K6 launches and RFAB gates by
    path recorded; every launch count is set to 0 just before the run and
    read just after."""
    import torch

    from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck
    from mri_super_resolution_tpu_torch.ops import rams_gate as rg
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk
    from mri_super_resolution_tpu_torch.ops import wire_kernel as wk
    from mri_super_resolution_tpu_torch.pipelines import misr

    per_case = []
    predict_case = misr.predict_case

    def recording(*args, **kwargs):
        before = dict(ck.LAUNCHES)
        gates = dict(rg.LAUNCHES)
        out = predict_case(*args, **kwargs)
        per_case.append((out, ck.LAUNCHES["conv3d_rfab"] - before["conv3d_rfab"],
                         {k: rg.LAUNCHES[k] - gates[k] for k in gates},
                         ck.LAUNCHES["conv3d_rfab_wg"] - before["conv3d_rfab_wg"]))
        return out

    misr.predict_case = recording
    try:
        for mod in (sk, wk, ck, rg):
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
    73.5 vs 121, for the committed RAMS on a (2, 16, 16, 9) input). Every
    route runs its 15 RFAB gates a case on G1, none eager. Returns the
    path's launches."""
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
    for case, ((mean_pred, adc), n, gates, wg) in zip(cases, per_case):
        base = os.path.join(out_dir, "smoke", case.pt_no)
        _require(all(os.path.isfile(os.path.join(base, k, "mean.dcm")) for k in ("DWI", "ADC")),
                 f"no DICOMs for case {case.pt_no}")
        _require(mean_pred.shape == adc.shape == (384, 384), "MISR output shape")
        _require(bool(np.isfinite(mean_pred).all() and mean_pred.min() >= 0
                      and mean_pred.max() <= 65536), "mean_pred finite and in [0, 65536]")
        _require(bool(np.isfinite(adc).all()), "ADC finite")
        _require(n == K6_PER_FORWARD, f"K6 launched {n} times for case {case.pt_no}, "
                 f"expected {K6_PER_FORWARD}")
        _require(wg == n, f"{wg} of case {case.pt_no}'s {n} K6 launches on the wgmma kernel")
        _require(gates == {"rfab_gate": G1_PER_FORWARD, "rfab_gate_eager": 0},
                 f"RFAB gates {gates} for case {case.pt_no}, expected {G1_PER_FORWARD} on G1")
    for name, n in launches.items():
        want = K6_PER_FORWARD * len(cases) if name in ("conv3d_rfab", "conv3d_rfab_wg") else 0
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
        for case, (_, n, gates, _) in zip(cases, pc):
            _require(n == 0 and gates == {"rfab_gate": G1_PER_FORWARD, "rfab_gate_eager": 0},
                     f"{name} route, case {case.pt_no}: K6 {n}, RFAB gates {gates}, expected "
                     f"no K6 and {G1_PER_FORWARD} on G1")
        route[name] = [out[0] for out, _, _, _ in pc]
    k6 = [out[0] for out, _, _, _ in per_case]
    gap = max(float(np.abs(a - b).max()) for a, b in zip(k6, route["library"]))
    own = max(float(np.abs(a - b).max()) for a, b in zip(route["library"], route["float32"]))
    print(f"[main misr] mean_pred, K6 route vs library route: max abs {gap:.2f}; library "
          f"bf16 vs float32: {own:.2f} (tol: route gap <= 2x that)")
    _require(gap <= 2 * own, "the K6 and library routes differ beyond the bf16 bound")
    return {"conv3d_rfab": launches["conv3d_rfab"],
            "conv3d_rfab_wg": launches["conv3d_rfab_wg"],
            "rfab_gate": sum(g["rfab_gate"] for _, _, g, _ in per_case)}


def _all_counts() -> dict:
    from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck
    from mri_super_resolution_tpu_torch.ops import mma_probe as mp
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk
    from mri_super_resolution_tpu_torch.ops import wire_kernel as wk

    return {**sk.LAUNCHES, **wk.LAUNCHES, **ck.LAUNCHES, **mp.LAUNCHES}


def _reset_all_counts() -> None:
    from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck
    from mri_super_resolution_tpu_torch.ops import mma_probe as mp
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk
    from mri_super_resolution_tpu_torch.ops import wire_kernel as wk

    for mod in (sk, wk, ck, mp):
        mod.reset_launches()


def _check_only(launches: dict, want: dict, path: str) -> None:
    for name, n in launches.items():
        _require(n == want.get(name, 0), f"{name} launched {n} times on the {path} path, "
                 f"expected {want.get(name, 0)}")


def _write_2d_volume(data_dir: str, seed: int, erd_map: bool) -> None:
    """A seeded (128, 128, 24) mean-b0 volume (the serving phase's blob,
    unit-scaled) as pat07_mean_b0.mat, with an ERD map when asked."""
    import numpy as np
    import scipy.io as sio

    os.makedirs(data_dir, exist_ok=True)
    b0 = _b0_blob(seed)
    sio.savemat(os.path.join(data_dir, "pat07_mean_b0.mat"),
                {"data_mean_b0": b0 / float(b0.max())})
    if erd_map:
        rng = np.random.default_rng(seed)
        sio.savemat(os.path.join(data_dir, "pat07_ERD.mat"),
                    {"ADC_alldata_mm_ERD": rng.uniform(0, 3, b0.shape).astype(np.float32)})


def phase_master_main(out_dir: str, steps: int, seg: int) -> tuple[dict, float]:
    """The 2-D directional ensemble: ``cli/master.main`` at full width on
    one synthetic registry case (acquisitions (9, 9, 9) synthesised from the
    volume), AutoERD mode 1, the steps cut to ``steps`` and ``seg``. Every
    launch count is set to 0 just before the run and read just after."""
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch.cli import master as master_cli
    from mri_super_resolution_tpu_torch.data import CONTRAST_HEADER

    data_dir = os.path.join(out_dir, "data")
    _write_2d_volume(data_dir, seed=41, erd_map=True)
    _reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    csv_path = master_cli.main([
        "--out_folder", os.path.join(out_dir, "exp"), "--out_img_folder",
        os.path.join(out_dir, "img"), "--total_steps", str(steps), "--seg", str(seg),
        "--erd", "1", "--limit_cases", "1", "--data_dir", data_dir, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _all_counts()
    want = {"siren_loss_grads_weighted_resident_tc_batched": steps * MASTER_SLOTS}
    _check_only(launches, want, "2-D ensemble")
    rows = [ln.split(",") for ln in open(csv_path).read().splitlines()]
    _require(rows[0] == list(CONTRAST_HEADER) and len(rows) == 1 + 4 * 8 * 3,
             f"the 2-D ensemble CSV has {len(rows)} lines")
    values = np.asarray([float(r[5]) for r in rows[1:]])
    _require(bool(np.isfinite(values).all()), "non-finite contrast metrics")
    for sub, n in (("DWI", 4), ("ADC", 6)):
        _require(len(os.listdir(os.path.join(out_dir, "img", "sr2", "07", sub))) == n,
                 f"{sub} DICOMs of the 2-D ensemble")
    superres = {r[2]: float(r[5]) for r in rows[1:] if r[3] == "superres" and r[4] == "C"}
    updates = steps * MASTER_SLOTS
    print(f"[main master] cli.master.main() {wall:.1f} s for {steps} steps (seg {seg}) x "
          f"{MASTER_SLOTS} acquisition slots = {updates} batched updates of the "
          f"{MASTER_DIRS} directions, {1e3 * wall / updates:.3f} ms a batched update end to "
          f"end ({1e3 * wall / (steps * MASTER_ACQ):.3f} ms a direction's update); launches "
          f"{want}; superres contrast C by direction {superres}")
    # the unbatched K1-w row's count is its own key's: 0, the path is batched
    return {**want, "siren_loss_grads_weighted_stream":
            launches["siren_loss_grads_weighted_stream"]}, wall


def phase_erd_main(out_dir: str, threshold: float) -> tuple[dict, tuple]:
    """The soft-ERD fit: ``cli/inr_erd.main`` at full width (SirenERD
    128x3, 9 acquisitions synthesised from the volume, one seed) with phase
    1 stopped at ``threshold``; each case's result recorded. Every launch
    count is set to 0 just before the run and read just after. Returns the
    launches and phase 1's (lr, coords, target)."""
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch.cli import inr_erd as erd_cli
    from mri_super_resolution_tpu_torch.data import CNR_SNR_HEADER
    from mri_super_resolution_tpu_torch.pipelines import inr_erd

    data_dir = os.path.join(out_dir, "data")
    _write_2d_volume(data_dir, seed=42, erd_map=False)
    results, fits = [], []
    run_case, fit_until = inr_erd.run_case, inr_erd.fit_until

    def recording(*args, **kwargs):
        res = run_case(*args, **kwargs)
        results.append(res)
        return res

    def recording_fit(apply_fn, lr, init_fn, coords, target, **kwargs):
        fits.append((lr, coords, target))
        return fit_until(apply_fn, lr, init_fn, coords, target, **kwargs)

    inr_erd.run_case, inr_erd.fit_until = recording, recording_fit
    try:
        _reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        csv_path = erd_cli.main([
            "--seeds", "1", "--limit_cases", "1", "--num_acq", "9", "--loss_threshold",
            str(threshold), "--out_csv", os.path.join(out_dir, "erd.csv"), "--models_dir",
            os.path.join(out_dir, "models"), "--data_dir", data_dir, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _all_counts()
    finally:
        inr_erd.run_case, inr_erd.fit_until = run_case, fit_until
    (res,) = results
    _check_only(launches, {"siren_loss_grads_absmax_stream": res.pretrain_steps}, "soft-ERD")
    _require(res.pretrain_steps > 0, "phase 1 took no step")
    _require(res.pretrain_steps < inr_erd.PRETRAIN_MAX_STEPS,
             f"phase 1 did not reach {threshold:g} in {inr_erd.PRETRAIN_MAX_STEPS} steps")
    _require(res.mean_recon.shape == (ERD_SIDE, ERD_SIDE)
             and bool(np.isfinite(res.mean_recon).all()), "soft-ERD mean reconstruction")
    lines = open(csv_path).read().splitlines()
    _require(lines[0] == ",".join(CNR_SNR_HEADER) and len(lines) == 5,
             f"the soft-ERD CSV has {len(lines)} lines")
    _require(sorted(os.listdir(os.path.join(out_dir, "models"))) ==
             ["18-1681-07.pt", "18-1681-07_0.pt"], "soft-ERD checkpoints")
    err = float(np.abs(res.mean_recon - res.mean_orig).mean())
    print(f"[main inr_erd] cli.inr_erd.main() {wall:.2f} s; phase 1 to loss <= "
          f"{threshold:g} in {res.pretrain_steps} steps; launches "
          f"{{'siren_loss_grads_absmax_stream': {res.pretrain_steps}}}; mean |recon - mean of the "
          f"acquisitions| {err:.4f}; CSV {lines[1:]}")
    return ({"siren_loss_grads_absmax_stream": launches["siren_loss_grads_absmax_stream"]},
            fits[0])


def phase_erd_routes(lr: float, coords, target, threshold: float) -> None:
    """The soft-ERD phase 1 at full width on the case's target from one
    init (the generator of seed 0) to ``threshold``, on K1-a's streaming
    route and on the SIMT route (``csrc/siren.cu`` through its launch
    code), in turns (streaming, SIMT, SIMT, streaming): each run's stop
    step, restarts, final loss and wall-clock. The routes' products differ
    in their last bits (bf16x3 against float32), and a fit amplifies that,
    so the stop steps and restarts are printed side by side, not required
    equal."""
    import torch

    from mri_super_resolution_tpu_torch.fit.engine import fit_until, plain_apply_init
    from mri_super_resolution_tpu_torch.models import SirenERD
    from mri_super_resolution_tpu_torch.ops import _build
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk
    from mri_super_resolution_tpu_torch.pipelines.inr_erd import PRETRAIN_MAX_STEPS

    model = SirenERD(2, ERD_HIDDEN, ERD_LAYERS, perturb=True, device="cuda")
    omega, acts = sk._model_omega_acts(model)
    P, stream = int(coords.shape[0]), _build.stream_ptr()

    def simt(params, x, t):
        return sk._launch_loss_grads(sk._lib(), x, params, t, omega, P, stream, acts, None, True)

    routes = {"streaming": sk.make_fused_value_grad_absmax(model), "SIMT": simt}
    runs = {}
    for name in ("streaming", "SIMT", "SIMT", "streaming"):
        _reset_all_counts()
        apply_fn, init_fn = plain_apply_init(model, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit_until(apply_fn, lr, init_fn, coords, target, threshold, PRETRAIN_MAX_STEPS,
                        routes[name])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = {"siren_loss_grads_absmax_stream": res.steps} if name == "streaming" else {}
        _check_only(_all_counts(), want, f"soft-ERD phase 1 ({name})")
        _require(res.steps < PRETRAIN_MAX_STEPS and res.loss <= threshold,
                 f"phase 1 on the {name} route did not reach {threshold:g}")
        runs.setdefault(name, []).append((res.steps, res.restarts, res.loss, wall))
        print(f"[parity] soft-ERD phase 1 at full width, {name} route: stops at step "
              f"{res.steps}, restarts at {res.restarts}, loss {res.loss:.6e}; {wall:.3f} s, "
              f"{1e3 * wall / res.steps:.4f} ms a step")
    same = runs["streaming"][0][:2] == runs["SIMT"][0][:2]
    print(f"[parity] soft-ERD phase 1, streaming vs SIMT route from one init: stop steps "
          f"{runs['streaming'][0][0]} vs {runs['SIMT'][0][0]}, restarts "
          f"{runs['streaming'][0][1]} vs {runs['SIMT'][0][1]} "
          f"({'the same' if same else 'they differ'}); each route repeats itself: "
          f"{runs['streaming'][0][:3] == runs['streaming'][1][:3]}, "
          f"{runs['SIMT'][0][:3] == runs['SIMT'][1][:3]}")
    _require(runs["streaming"][0][:3] == runs["streaming"][1][:3],
             "two streaming-route phase-1 runs from one init differ")


def phase_lowres_main(out_dir: str) -> dict:
    """The half-res quality harness: ``cli/superres_lowres.main`` at full
    width (SirenERD 128x3, 9 acquisitions synthesised from a seeded 128 x
    128 volume, the cancer slice, phase 1 to 2e-5, 500 phase-2 steps), once
    with the reference protocol and once with ``--split_protocol``. Every
    launch count is set to 0 just before each run and read just after:
    exactly one K1-a launch on the streaming route a phase-1 step, no other
    kernel. Phase 1 (``fit_until``) and phase 2 with the soft-ERD weights
    (to the SR's ``recon_mean``) are timed on the host clock, synchronised.
    Returns the reference run's launches under the kernels line's name."""
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch.cli import superres_lowres as lowres_cli
    from mri_super_resolution_tpu_torch.pipelines import lowres_qual

    data_dir = os.path.join(out_dir, "data")
    _write_2d_volume(data_dir, seed=43, erd_map=False)
    run_slice, fit_until, recon_mean = (lowres_qual.run_slice, lowres_qual.fit_until,
                                        lowres_qual.recon_mean)
    steps = {}
    for protocol in ("reference", "split"):
        results, marks = [], {}

        def recording(*args, **kwargs):
            res = run_slice(*args, **kwargs)
            results.append(res)
            return res

        def timed_fit(*args, **kwargs):
            torch.cuda.synchronize()
            marks["fit"] = time.perf_counter()
            res = fit_until(*args, **kwargs)
            torch.cuda.synchronize()
            marks["phase2"] = time.perf_counter()
            return res

        def timed_recon(*args, **kwargs):
            torch.cuda.synchronize()
            marks["sr"] = time.perf_counter()
            return recon_mean(*args, **kwargs)

        out_csv = os.path.join(out_dir, f"lowres_{protocol}.csv")
        lowres_qual.run_slice, lowres_qual.fit_until, lowres_qual.recon_mean = (
            recording, timed_fit, timed_recon)
        try:
            _reset_all_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lowres_cli.main([
                "--limit_cases", "1", "--num_acq", "9", "--cancer_slice_only",
                "--loss_threshold", str(ERD_THRESHOLD), "--out_csv", out_csv, "--data_dir",
                data_dir, "--device", "cuda", *(["--split_protocol"] if protocol == "split"
                                                else [])])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _all_counts()
        finally:
            lowres_qual.run_slice, lowres_qual.fit_until, lowres_qual.recon_mean = (
                run_slice, fit_until, recon_mean)
        (res,) = results
        cfg = lowres_qual.LowresQualConfig()
        _check_only(launches, {"siren_loss_grads_absmax_stream": res.pretrain_steps},
                    f"half-res quality ({protocol})")
        _require(0 < res.pretrain_steps < cfg.max_pretrain_steps,
                 f"phase 1 did not reach {ERD_THRESHOLD:g} in {cfg.max_pretrain_steps} steps")
        _require(res.sr.shape == (ERD_SIDE, ERD_SIDE) and bool(np.isfinite(res.sr).all()),
                 "half-res SR shape")
        _require(res.lr.shape == (LOWRES_SIDE, LOWRES_SIDE), "half-res LR shape")
        rows = [ln.split(",") for ln in open(out_csv).read().splitlines()]
        _require(rows[0] == list(lowres_qual.LOWRES_QUAL_HEADER) and len(rows) == 2,
                 f"the half-res CSV has {len(rows)} lines")
        values = np.asarray([float(v) for v in rows[1][2:]])
        _require(bool(np.isfinite(values).all()), "non-finite half-res metrics")
        phase1 = marks["phase2"] - marks["fit"]
        phase2 = marks["sr"] - marks["phase2"]
        steps[protocol] = res.pretrain_steps
        print(f"[main lowres {protocol}] cli.superres_lowres.main() {wall:.2f} s; phase 1 to "
              f"loss <= {ERD_THRESHOLD:g} in {res.pretrain_steps} steps on {LOWRES_SIDE}x"
              f"{LOWRES_SIDE} = {LOWRES_SIDE ** 2} rows, {phase1:.3f} s "
              f"({1e3 * phase1 / res.pretrain_steps:.3f} ms a step); phase 2 "
              f"({cfg.phase2_steps} steps, soft-ERD weights included) {phase2:.3f} s "
              f"({1e3 * phase2 / cfg.phase2_steps:.3f} ms a step); launches "
              f"{{'siren_loss_grads_absmax_stream': {res.pretrain_steps}}}; CSV {rows[1]}")
    return {"siren_loss_grads_absmax_stream_lowres": steps["reference"]}


def phase_small_clis(out_dir: str) -> None:
    """Short runs of ``cli/david.main`` (one synthetic case, AutoERD on the
    card), ``cli/inr_toy.main`` (500 steps at its full width) and
    ``cli/automate_inr.main --use_pn`` (200 epochs, 100 on the mean, at its
    full width) on the card, none of which launches a kernel; each one's
    output checked and its wall-clock printed."""
    import numpy as np
    import scipy.io as sio
    import torch

    from mri_super_resolution_tpu_torch.cli import automate_inr as automate_cli
    from mri_super_resolution_tpu_torch.cli import david as david_cli
    from mri_super_resolution_tpu_torch.cli import inr_toy as toy_cli
    from mri_super_resolution_tpu_torch.pipelines import erd_stats

    data_dir = os.path.join(out_dir, "data")
    _write_2d_volume(data_dir, seed=44, erd_map=True)
    walls = {}
    previous = os.environ.get("MRI_SR_DATA_DIR")
    os.environ["MRI_SR_DATA_DIR"] = data_dir
    try:
        _reset_all_counts()
        t0 = time.perf_counter()
        path = david_cli.main(["--limit_cases", "1", "--out_folder",
                               os.path.join(out_dir, "david"), "--device", "cuda"])
        torch.cuda.synchronize()
        walls["david"] = time.perf_counter() - t0
    finally:
        if previous is None:
            del os.environ["MRI_SR_DATA_DIR"]
        else:
            os.environ["MRI_SR_DATA_DIR"] = previous
    _check_only(_all_counts(), {}, "david")
    rows = [ln.split(",") for ln in open(path).read().splitlines()]
    _require(rows[0] == list(erd_stats.HEADER) and len(rows) == 1 + 3 * (9 * 4 + 8),
             f"the david CSV has {len(rows)} lines")
    _require(bool(np.isfinite([float(r[5]) for r in rows[1:]]).all()), "non-finite david rows")

    toy_out = os.path.join(out_dir, "toy", "toy_model.pt")
    t0 = time.perf_counter()
    mse = toy_cli.main(["--max_steps", "500", "--out", toy_out, "--device", "cuda"])
    walls["inr_toy"] = time.perf_counter() - t0
    _check_only(_all_counts(), {}, "inr_toy")
    _require(os.path.isfile(toy_out) and np.isfinite(mse), "inr_toy wrote no model")
    torch.load(toy_out)

    mat = os.path.join(out_dir, "automate.mat")
    t0 = time.perf_counter()
    automate_cli.main(["--epochs", "200", "--mean_epochs", "100", "--use_pn", "--out", mat,
                       "--device", "cuda"])
    walls["automate_inr"] = time.perf_counter() - t0
    _check_only(_all_counts(), {}, "automate_inr")
    saved = sio.loadmat(mat)
    _require({"recon", "sr_epochs"} <= set(saved) and saved["recon"].shape == (256, 256)
             and saved["sr_epochs"].shape == (256, 256, 2)
             and bool(np.isfinite(saved["sr_epochs"]).all()),
             "automate_inr's .mat keys or snapshot count")
    print(f"[main small CLIs] cli.david.main() {walls['david']:.2f} s ({len(rows) - 1} rows); "
          f"cli.inr_toy.main() 500 steps at 128x128 {walls['inr_toy']:.2f} s, final mse "
          f"{mse:.3e}; cli.automate_inr.main() --use_pn 200 epochs (100 on the mean, 256x256, "
          f"50 acquisitions) {walls['automate_inr']:.2f} s, 2 snapshots; no kernel launched")


def phase_k1a_trace(side: int = ERD_SIDE) -> None:
    """K1_TRACE_STEPS Adam steps at phase 1's lr (3e-4) at the soft-ERD
    fit's shape (or on the ``side`` x ``side`` grid) from one init, K1-a on
    its streaming route against the plain K1-a on the card; the losses step
    by step."""
    import torch

    from mri_super_resolution_tpu_torch.fit.optim import Adam
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    model, x, target = _erd_inputs(seed=35, last_bias=0.05, side=side)
    ws, acts = model.weights(), model.acts
    vags = {"kernel": lambda p: sk.siren_loss_grads(x, p, target, acts=acts,
                                                    with_out_absmax=True),
            "plain": lambda p: sk.siren_loss_grads_ref(x, p, target, 30.0, None, acts, None,
                                                       True)}
    traces = {}
    for route, vag in vags.items():
        params = [w.clone() for w in ws]
        opt = Adam(params, ERD_LR)
        losses = []
        for _ in range(K1_TRACE_STEPS):
            loss, _, grads = vag(params)
            losses.append(loss)
            opt.step(grads)
        traces[route] = torch.stack(losses).tolist()
    k, p = traces["kernel"], traces["plain"]
    rel = max(abs(a / b - 1.0) for a, b in zip(k, p))
    print(f"[parity] K1-a {K1_TRACE_STEPS}-step Adam trace (lr {ERD_LR:g}) at 2 -> 128x4 -> "
          f"128 -> 1 on {side * side} rows, streaming route vs plain: loss {p[0]:.6e} -> "
          f"{p[-1]:.6e} (plain), {k[-1]:.6e} (kernel); worst step rel {rel:.3e} (tol "
          f"{K1_TRACE_RTOL:g})")
    _require(rel <= K1_TRACE_RTOL and k[-1] < k[0], "K1-a's Adam trace departs from the plain one")


def phase_k1a_lowres_parity() -> dict:
    """K1-a on its streaming route at the half-res harness's LR slice: 64 x
    64 = 4,096 rows (32 row tiles, so 32 slots in the fixed-order sum) and
    63 x 63 = 3,969 rows (a last tile of one row), against the plain K1-a:
    at SirenERD's init with the output bias at 0.05, then with a collapsed
    output (bias -10: max |out| and every gradient exactly 0); twice for the
    same bits; then a K1_TRACE_STEPS-step Adam trace at 4,096 rows. Returns
    its max abs error."""
    import torch

    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    worst_all = (0.0, 0.0)
    dims = (2,) + (ERD_HIDDEN,) * (ERD_LAYERS + 2) + (1,)
    key = sk.loss_grads_key(False, True, "stream")
    for side in (LOWRES_SIDE, LOWRES_RAGGED_SIDE):
        P = side * side
        for bias in (0.05, -10.0):
            model, x, target = _erd_inputs(seed=32, last_bias=bias, side=side)
            ws, acts = model.weights(), model.acts
            _require(sk.k1_route(dims, acts, False, True) == "stream",
                     "K1-a at the LR slice is not of the streaming route's class")
            before = dict(sk.LAUNCHES)
            loss, am, grads = sk.siren_loss_grads(x, ws, target, acts=acts, with_out_absmax=True)
            again = sk.siren_loss_grads(x, ws, target, acts=acts, with_out_absmax=True)
            loss_r, am_r, grads_r = sk.siren_loss_grads_ref(x, ws, target, 30.0, None, acts,
                                                            None, True)
            torch.cuda.synchronize()
            _require(sk.LAUNCHES == {**before, key: before[key] + 2},
                     "K1-a at the LR slice did not take the streaming route")
            worst = _worst_rel([(loss, loss_r), *zip(grads, grads_r)])
            loss_rel, am_rel = _rel(loss, loss_r)[1], _rel(am, am_r)[1]
            print(f"[parity] K1 absmax/ReLU at the half-res LR slice P={P} ({P // sk.ST_TM} full "
                  f"tiles + {P % sk.ST_TM} rows) last bias {bias:g}, streaming route: loss "
                  f"{float(loss):.6e} vs {float(loss_r):.6e} (rel {loss_rel:.2e}, tol "
                  f"{K1A_LOSS_RTOL:g}); max |out| {float(am):.6e} vs {float(am_r):.6e} (rel "
                  f"{am_rel:.2e}, tol {K1_ABSMAX_TOL:g}); worst over loss/dW max abs "
                  f"{worst[0]:.3e}, rel {worst[1]:.3e} (tol rel {K1_K2_TOL:g})")
            _require(all(torch.equal(a, b) for a, b in zip([loss, am, *grads],
                                                            [again[0], again[1], *again[2]])),
                     "two streaming K1-a calls at the LR slice differ")
            if bias < 0:
                _require(float(am) == 0.0 and all(float(g.abs().max()) == 0.0 for g in grads),
                         "a collapsed output must give max |out| 0 and zero gradients")
            else:
                _require(worst[1] <= K1_K2_TOL and am_rel <= K1_ABSMAX_TOL
                         and loss_rel <= K1A_LOSS_RTOL,
                         "K1-a at the LR slice disagrees with its plain version")
                worst_all = max(worst_all, worst, (float((am - am_r).abs()), am_rel))
    phase_k1a_trace(LOWRES_SIDE)
    return {"siren_loss_grads_absmax_stream_lowres": worst_all[0]}


def phase_probe_main(out_dir: str) -> dict:
    """The P1 probe: ``cli/int8_mma_probe.main`` at its full shape; every
    launch count set to 0 just before the run and read just after."""
    from mri_super_resolution_tpu_torch.cli import int8_mma_probe as probe_cli

    out = os.path.join(out_dir, "int8_mma_probe.json")
    _reset_all_counts()
    rec = probe_cli.main(["--calls", str(PROBE_CALLS), "--out", out, "--device", "cuda"])
    launches = _all_counts()
    want = {"mma_probe_bf16": 1 + PROBE_CALLS, "mma_probe_int8": 1 + PROBE_CALLS}
    _check_only(launches, want, "probe")
    saved = json.load(open(out))
    _require(set(saved) == {"platform", "device", "tile", "reps", "grid", "cases"}
             and saved["tile"] == [PROBE_T, PROBE_H] and saved["grid"] == PROBE_GRID
             and set(saved["cases"]) == {"bf16_f32acc", "int8_i32acc"},
             "the probe's JSON lacks the JAX probe's keys")
    print(f"[main probe] cli.int8_mma_probe.main(): {json.dumps(rec['cases'])}; launches "
          f"{want}")
    return {k: launches[k] for k in want}


def phase_k1a_lowres_time(errs: dict, launches: dict) -> dict:
    """K1-a on its streaming route at the half-res harness's 4,096 LR rows,
    beside the plain K1-a, eager autograd of the same loss with max |out|
    and its bound (the route's bf16x3 products at the bf16 peak); its
    device time by pass under ``torch.profiler``."""
    import torch

    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    model, x, target = _erd_inputs(seed=53, last_bias=0.05, side=LOWRES_SIDE)
    ws, acts = model.weights(), model.acts
    P = LOWRES_SIDE * LOWRES_SIDE
    dims = (2,) + (ERD_HIDDEN,) * (ERD_LAYERS + 2) + (1,)
    macs = _layer_macs(dims)
    lib_params = [w.clone().requires_grad_() for w in ws]

    def lib_absmax():
        out = sk.siren_forward_ref(x, lib_params, 30.0, acts)
        torch.autograd.grad(torch.mean((out - target) ** 2), lib_params)
        out.detach().abs().max()

    flops = 2 * P * (2 * sum(macs) + sum(macs[1:]))
    kern = lambda: sk.siren_loss_grads(x, ws, target, acts=acts, with_out_absmax=True)
    row = _time_row(
        "siren_loss_grads_absmax_stream_lowres", "siren_stream", "siren_kernel.py:518", kern,
        lambda: sk.siren_loss_grads_ref(x, ws, target, 30.0, None, acts, None, True),
        lib_absmax, 3 * flops, 4 * x.numel() + 8 * sum(w.numel() for w in ws) + 4 * P + 8,
        f"P={P} (half-res LR slice)", errs, launches, peak=PEAK_BF16_TC, reps=50, rounds=2)
    _passes("K1-absmax (streaming) at the LR slice", kern, calls=20)
    return row


def phase_2d_times(errs: dict, launches: dict) -> list[dict]:
    """K1-weighted at the 2-D ensemble's shape, unbatched (the streaming
    route), and K1-absmax at the soft-ERD fit's, beside their plain
    versions, eager autograd of the same loss and their bounds (the
    streaming route's bf16x3 products at the bf16 peak); K1-absmax's SIMT
    route in turns with the streaming one (CUDA events) and each one's
    device time under ``torch.profiler``; then the per-update costs of the
    two paths on the host clock: a K1 call (its launches' host time
    included), an Adam step over the same params, a whole update, the
    soft-ERD step on either K1-a route and ``fit_until``'s per-step
    read-back of the loss and max |out| (200 steps with and without it)."""
    import torch

    from mri_super_resolution_tpu_torch.fit.optim import Adam
    from mri_super_resolution_tpu_torch.ops import _build
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    rows = []
    model, x, target, sw = _master_inputs(seed=51)
    ws, acts = model.weights(), model.acts
    dims = (2,) + (MASTER_HIDDEN,) * (MASTER_LAYERS + 1) + (1,)
    macs = _layer_macs(dims)
    wbytes = 4 * sum(w.numel() for w in ws)
    lib_model = type(model)(2, MASTER_HIDDEN, MASTER_LAYERS).cuda()
    lib_model.load_state_dict(model.state_dict())
    lib_params = list(lib_model.parameters())

    def lib_weighted():
        loss = torch.mean(sw * (lib_model(x) - target) ** 2)
        torch.autograd.grad(loss, lib_params)

    k1w = lambda: sk.siren_loss_grads(x, ws, target, acts=acts, sample_weights=sw)
    stream = _build.stream_ptr()
    flops = 2 * MASTER_P * (2 * sum(macs) + sum(macs[1:]))
    rows.append(_time_row(
        "siren_loss_grads_weighted_stream", "siren_stream", "siren_kernel.py:518",
        k1w, lambda: sk.siren_loss_grads_ref(x, ws, target, 30.0, None, acts, sw),
        lib_weighted, 3 * flops, 4 * x.numel() + 2 * wbytes + 8 * MASTER_P + 4, f"P={MASTER_P}",
        errs, launches, peak=PEAK_BF16_TC, reps=100, rounds=2))
    _passes("K1-weighted (streaming)", k1w, calls=20)
    params = [w.clone() for w in ws]
    opt = Adam(params, 3e-4)
    grads = k1w()[1]

    def update():
        opt.step(sk.siren_loss_grads(x, params, target, acts=acts, sample_weights=sw)[1])

    host = {}
    for what, fn in (("K1 call", k1w), ("Adam step", lambda: opt.step(grads)),
                     ("update", update)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn()
        torch.cuda.synchronize()
        host[what] = 1e3 * (time.perf_counter() - t0) / 500
    print(f"[times] unbatched 2-D ensemble update on the host clock (500 in a row): "
          f"K1-weighted call {host['K1 call']:.4f} ms, Adam step "
          f"({len(ws)} tensors) {host['Adam step']:.4f} ms, K1 + Adam "
          f"{host['update']:.4f} ms; kernel alone {rows[-1]['ms']:.4f} ms (CUDA events)")

    model, x, target = _erd_inputs(seed=52, last_bias=0.05)
    ws, acts = model.weights(), model.acts
    P = ERD_SIDE * ERD_SIDE
    dims = (2,) + (ERD_HIDDEN,) * (ERD_LAYERS + 2) + (1,)
    macs = _layer_macs(dims)
    wbytes = 4 * sum(w.numel() for w in ws)
    lib_params = [w.clone().requires_grad_() for w in ws]

    def lib_absmax():
        out = sk.siren_forward_ref(x, lib_params, 30.0, acts)
        torch.autograd.grad(torch.mean((out - target) ** 2), lib_params)
        out.detach().abs().max()

    flops = 2 * P * (2 * sum(macs) + sum(macs[1:]))
    stream_k1a = lambda: sk.siren_loss_grads(x, ws, target, acts=acts, with_out_absmax=True)
    simt_k1a = lambda: sk._launch_loss_grads(sk._lib(), x, ws, target, 30.0, P, stream, acts,
                                             None, True)
    # the streaming route's bound: its bf16x3 products at the bf16 peak
    rows.append(_time_row(
        "siren_loss_grads_absmax_stream", "siren_stream", "siren_kernel.py:518", stream_k1a,
        lambda: sk.siren_loss_grads_ref(x, ws, target, 30.0, None, acts, None, True),
        lib_absmax, 3 * flops, 4 * x.numel() + 2 * wbytes + 4 * P + 8, f"P={P}", errs,
        launches, peak=PEAK_BF16_TC))
    new_ms, simt_ms = _best_alternating(stream_k1a, simt_k1a, 50, 2)
    print(f"[times] K1-absmax at P={P}, routes in turns (CUDA events, 50 calls, best of 2): "
          f"streaming {new_ms:.4f} ms ({3 * flops / new_ms / 1e9:.1f} TFLOP/s of bf16 "
          f"products; bound {3 * flops / PEAK_BF16_TC * 1e3:.4f} ms), SIMT (csrc/siren.cu) "
          f"{simt_ms:.4f} ms (f32 bound {flops / PEAK_F32_FLOPS * 1e3:.4f} ms)")
    _passes("K1-absmax (streaming)", stream_k1a, calls=20)
    _passes("K1-absmax (SIMT)", simt_k1a, calls=20)
    omega, _ = sk._model_omega_acts(model)
    vags = {"streaming": sk.make_fused_value_grad_absmax(model),
            "SIMT": lambda params, xx, t: sk._launch_loss_grads(sk._lib(), xx, params, t, omega,
                                                                P, stream, acts, None, True)}
    steps = {}
    for route in ("streaming", "SIMT", "SIMT", "streaming"):
        for readback in (False, True):
            params = [w.clone() for w in ws]
            opt = Adam(params, ERD_LR)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                loss, am, g = vags[route](params, x, target)
                opt.step(g)
                if readback:
                    torch.stack([loss, am]).tolist()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / 200
            steps[route, readback] = min(steps.get((route, readback), float("inf")), ms)
    for route in ("streaming", "SIMT"):
        print(f"[times] soft-ERD phase-1 step on the {route} route (K1-absmax + Adam, 200 in a "
              f"row, best of 2, routes in turns): {steps[route, False]:.3f} ms without the "
              f"per-step read-back, {steps[route, True]:.3f} ms with it: the read-back costs "
              f"{steps[route, True] - steps[route, False]:.3f} ms a step")
    return rows


def phase_probe_times(errs: dict, launches: dict) -> list[dict]:
    """P1 at the full shape (GRID 512) and at GRID 256 with CUDA events: the
    time must scale with GRID (a ratio of 1.7 to 2.3). Beside it the plain
    version and one library call over the same GRID x REPS products, (GRID
    REPS T, H) x (H, H): ``torch.matmul`` in bf16, ``torch._int_mm`` in int8
    (int32 out); its output traffic is GRID REPS times the probe's."""
    import torch

    from mri_super_resolution_tpu_torch.ops import mma_probe as mp

    rows = []
    flops = 2 * PROBE_T * PROBE_H * PROBE_H * PROBE_REPS * PROBE_GRID
    for dtype, key, peak in ((torch.bfloat16, "mma_probe_bf16", PEAK_BF16_TC),
                             (torch.int8, "mma_probe_int8", PEAK_INT8_TC)):
        a, b, bt = _probe_operands(dtype)
        half = _time_ms(lambda: mp.mma_probe(a, b, PROBE_REPS, PROBE_GRID // 2, bt), 5)
        a_rep = a.repeat(PROBE_GRID, 1)
        if dtype == torch.int8:
            lib = lambda: torch._int_mm(a_rep, bt.t())
        else:
            lib = lambda: torch.matmul(a_rep, b)
        nbytes = a.numel() * a.element_size() + b.numel() * b.element_size() + 4 * PROBE_T * PROBE_H
        row = _time_row(key, "mma_probe", "", lambda: mp.mma_probe(a, b, PROBE_REPS,
                                                                    PROBE_GRID, bt),
                        lambda: mp.mma_probe_ref(a, b, PROBE_REPS, PROBE_GRID), lib, flops,
                        nbytes, f"T={PROBE_T} H={PROBE_H} REPS={PROBE_REPS} GRID={PROBE_GRID}",
                        errs, launches, peak=peak, reps=5)
        row["replaces"] = "scripts/int8_mxu_probe.py:57"
        ratio = row["ms"] / half
        print(f"[times] {key}: GRID {PROBE_GRID // 2} {half:.3f} ms, GRID {PROBE_GRID} "
              f"{row['ms']:.3f} ms (ratio {ratio:.2f}); {flops / row['ms'] / 1e9:.1f} "
              f"T(FL)OP/s = {100 * row['bound_ms'] / row['ms']:.1f}% of the dense peak; "
              f"library over the same products {flops / row['library_ms'] / 1e9:.1f} T(FL)OP/s")
        _require(1.7 <= ratio <= 2.3, f"P1's time does not scale with GRID ({ratio:.2f})")
        rows.append(row)
        del a_rep
        torch.cuda.empty_cache()
    return rows


def phase_k6_times(err: float, launches: dict) -> dict:
    """K6 in bf16 at each MISR path shape: the kernel, its plain version and
    ``F.conv3d`` on the same channels-last tensors (bias in bf16), with CUDA
    events, beside the bound; kernel and ``F.conv3d`` in three alternating
    rounds, best of each. The kernels-line row is the SAME shape that runs
    25 of the 34 launches."""
    import torch
    import torch.nn.functional as F

    from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck

    from mri_super_resolution_tpu_torch.ops import _build

    row = None
    per_forward = {"kernel": 0.0, "library": 0.0, "wgmma": 0.0, "mma.sync": 0.0, "bound": 0.0}
    lib = ck._lib()
    stream = _build.stream_ptr()
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
                          peak=PEAK_BF16_TC, reps=5, rounds=3)
            wg_ms, sync_ms = _best_alternating(
                lambda: ck._launch(lib, x, wb, b, pad, stream, fn=lib.conv3d_rfab_bf16_wg),
                lambda: ck._launch(lib, x, wb, b, pad, stream, fn=lib.conv3d_rfab_bf16), 5, 3)
            print(f"[times] K6 {shape} {pad}, the two kernels in turns (best of 3): wgmma "
                  f"{wg_ms:.3f} ms, mma.sync {sync_ms:.3f} ms, bound {r['bound_ms']:.3f} ms; "
                  f"wgmma/mma.sync {wg_ms / sync_ms:.3f}, wgmma/bound "
                  f"{wg_ms / r['bound_ms']:.2f}")
            per_forward["kernel"] += n * r["ms"]
            per_forward["library"] += n * r["library_ms"]
            per_forward["wgmma"] += n * wg_ms
            per_forward["mma.sync"] += n * sync_ms
            per_forward["bound"] += n * r["bound_ms"]
            if row is None:
                row = r
            del x, xt
        torch.cuda.empty_cache()
    print(f"[times] K6 per RAMS forward (34 launches): kernel {per_forward['kernel']:.2f} ms, "
          f"F.conv3d {per_forward['library']:.2f} ms; in turns: wgmma "
          f"{per_forward['wgmma']:.2f} ms, mma.sync {per_forward['mma.sync']:.2f} ms, bound "
          f"{per_forward['bound']:.2f} ms")
    return row


def phase_g1_times(err: float, launches: dict) -> dict:
    """G1 in bf16 at each RFAB shape of the MISR path: the fused gate and the
    eager chain it replaces (``RFAB.gate_eager``) in three alternating
    rounds, best of each, and its plain version, with CUDA events, beside
    the bound (x and res read once and the output written once at 3.35
    TB/s; the two passes over x that the mean forces read x twice); its
    three passes by time at the body's shape. The kernels-line row is the
    body's shape, 12 of a forward's 15 gates."""
    import torch

    from mri_super_resolution_tpu_torch.ops import rams_gate as rg

    row = None
    per_forward = {"kernel": 0.0, "library": 0.0, "bound": 0.0}
    with torch.inference_mode():
        for i, (shape, n) in enumerate(G1_SHAPES):
            blk, x, res, weights = _g1_problem(shape, torch.bfloat16, seed=i)
            ms, eager_ms = _best_alternating(lambda: rg.rfab_gate(x, res, *weights),
                                             lambda: blk.gate_eager(x, res), 5, 3)
            plain_ms = _time_ms(lambda: rg.rfab_gate_ref(x, res, *weights), 5)
            nbytes = 3 * 2 * x.numel()
            bound = nbytes / PEAK_BYTES * 1e3
            print(f"[times] rfab_gate {shape}: kernel {ms:.3f} ms, eager chain {eager_ms:.3f} "
                  f"ms, plain {plain_ms:.3f} ms, bound {bound:.3f} ms ({nbytes / 1e6:.1f} MB; "
                  f"two passes {4 / 3 * bound:.3f} ms) -> {nbytes / ms / 1e6:.0f} GB/s; "
                  f"kernel/eager {ms / eager_ms:.3f}, kernel/bound {ms / bound:.2f}")
            per_forward["kernel"] += n * ms
            per_forward["library"] += n * eager_ms
            per_forward["bound"] += n * bound
            if row is None:
                _passes("G1 at the body's shape", lambda: rg.rfab_gate(x, res, *weights))
                row = {
                    "name": "rfab_gate", "route": "cuda",
                    "source": "mri_super_resolution_tpu_torch/csrc/rams_gate.cu",
                    "replaces": None, "launches": launches["rfab_gate"],
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": "bytes", "library_ms": eager_ms,
                }
            del x, res
        torch.cuda.empty_cache()
    print(f"[times] G1 per RAMS forward ({G1_PER_FORWARD} gates): kernel "
          f"{per_forward['kernel']:.2f} ms, eager chain {per_forward['library']:.2f} ms, "
          f"bound {per_forward['bound']:.2f} ms")
    return row


def phase_rams_forward_times() -> None:
    """The 25-draw RAMS forward at full width on a (25, 128, 128, 9) stack,
    bf16, with conv_kernel on and off (host clock around the synchronised
    forward, best of 3), then one forward per route under the profiler."""
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
    for conv_kernel in (True, False):
        with torch.inference_mode():
            _device_busy(f"RAMS 25-draw forward, conv_kernel={conv_kernel}",
                         lambda: models[conv_kernel](x))


def _k7_inputs(shape, padding, dtype, seed: int):
    """K6's inputs plus a cotangent of the output's shape, on the card."""
    import torch

    from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck

    x, w, _ = _k6_inputs(shape, dtype, seed)
    gen = torch.Generator().manual_seed(seed + 1000)
    g = torch.randn((*ck.out_shape(shape, padding), shape[-1]), generator=gen)
    return x, w, g.to("cuda", dtype)


def _k7_check(got, ref, what: str) -> float:
    """Hold K7 against its plain version: dx as K6's output (_k6_check's
    tolerances), dW and db within K7_DW_TOL of their largest entry. Returns
    the max abs error over the three."""
    errs = [_k6_check(got[0], ref[0], f"{what} dx", kernel="K7 conv3d_rfab_bwd")]
    for a, b, name in ((got[1], ref[1], "dW"), (got[2], ref[2], "db")):
        e, r = _rel(a, b)
        print(f"[parity] K7 conv3d_rfab_bwd {what} {name}: max abs {e:.3e}, rel {r:.3e} "
              f"(tol rel {K7_DW_TOL:g})")
        _require(r <= K7_DW_TOL, f"K7 {name} disagrees with its plain version ({what})")
        errs.append(e)
    return max(errs)


def phase_k7_parity() -> float:
    """K7 against its plain version at the seven training path shapes in
    bf16 and float32, and on ragged shapes (B 1, H != W, odd sizes, C 8 and
    16, SAME and VALID); returns the max abs error over the path's bf16
    calls."""
    import torch

    from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck

    err = 0.0
    for i, (shape, pad, _) in enumerate(TRAIN_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            x, w, g = _k7_inputs(shape, pad, dtype, seed=100 + i)
            e = _k7_check(ck.conv3d_rfab_bwd(x, w, g, pad), ck.conv3d_rfab_bwd_ref(x, w, g, pad),
                          f"{shape} {pad} {str(dtype)[6:]}")
            if dtype == torch.bfloat16:
                err = max(err, e)
            del x, g
    for shape, pad in (((1, 37, 21, 5, 8), "SAME"), ((1, 19, 45, 7, 16), "VALID"),
                       ((1, 3, 5, 3, 16), "VALID"), ((3, 17, 33, 4, 16), "SAME")):
        for dtype in (torch.bfloat16, torch.float32):
            x, w, g = _k7_inputs(shape, pad, dtype, seed=sum(shape))
            _k7_check(ck.conv3d_rfab_bwd(x, w, g, pad), ck.conv3d_rfab_bwd_ref(x, w, g, pad),
                      f"{shape} {pad} {str(dtype)[6:]}")
    torch.cuda.empty_cache()
    return err


def _tiny_train_data(n: int, lr_side: int, seed: int):
    """Seeded LR stacks in the uint16 range and HR targets (3x) with a
    mask, as float32 numpy arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.uniform(6000, 9000, (n, lr_side, lr_side, 9)).astype(np.float32)
    y = rng.uniform(6000, 9000, (n, 3 * lr_side, 3 * lr_side, 1)).astype(np.float32)
    return x, y, np.ones_like(y)


def phase_small_train(out_dir: str) -> None:
    """A small float32 RAMS (filters 8, N 1, r 4) with conv_kernel: three
    optimizer steps of the port's Trainer on the card's K6 and K7 against
    the same steps on the plain path on the CPU, from the same init on the
    same batches. The loss trace within rtol 1e-4 (float32 sums in other
    orders); the final params within 2 lr a step (Adam's update is about lr
    sign(g), and a gradient near 0 may take the other sign)."""
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch.config import RAMSConfig, TrainerConfig
    from mri_super_resolution_tpu_torch.fit.trainer import Trainer
    from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck
    from mri_super_resolution_tpu_torch.pipelines import misr

    x, y, m = _tiny_train_data(8, 12, seed=5)
    cfg = RAMSConfig(filters=8, N=1, r=4, compute_dtype="float32", conv_kernel=True)
    runs = {}
    for device in ("cuda", "cpu"):
        model = misr.build_rams(cfg, generator=torch.Generator().manual_seed(3))
        tr = Trainer(model, TrainerConfig(batch_size=4, hr_size=36, checkpoint_dir=os.path.join(
            out_dir, device)), device=device)
        tr.init()
        ck.reset_launches()
        losses = [float(tr.train_step([tr._batch(np.arange(i, i + 4) % 8, x, y, m)])[0])
                  for i in (0, 4, 2)]
        runs[device] = (np.asarray(losses), {k: v.detach().cpu() for k, v in
                                             tr.model.named_parameters()},
                        dict(ck.LAUNCHES))
    (lg, pg, launches), (lc, pc, _) = runs["cuda"], runs["cpu"]
    perr = max(float((pg[k] - pc[k]).abs().max()) for k in pg)
    lr = TrainerConfig().learning_rate
    print(f"[parity] small RAMS (8, 1) 3 train steps, card K6/K7 vs CPU plain: loss trace "
          f"{np.array2string(lg, precision=4)} vs {np.array2string(lc, precision=4)}, max rel "
          f"{float(np.abs(lg / lc - 1).max()):.3e} (tol 1e-4); params max abs {perr:.3e} "
          f"(tol {6 * lr:g}); launches {launches}")
    _require(bool(np.allclose(lg, lc, rtol=1e-4, atol=0)), "small RAMS loss trace disagrees")
    _require(perr <= 2 * lr * 3, "small RAMS params disagree after 3 steps")
    _require(launches == {"conv3d_rfab": 3 * 12, "conv3d_rfab_bwd": 3 * 12, "conv3d_rfab_wg": 0},
             f"small RAMS training launches {launches}")


def _write_b0_volumes(data_dir: str) -> None:
    """Three seeded synthetic mean-b0 volumes (128, 128, 24) at DWI
    magnitudes (the serving phase's blob), as ``patNN_mean_b0.mat`` under
    the first three CASE_TABLE patient numbers."""
    import scipy.io as sio

    from mri_super_resolution_tpu_torch.data import CASE_TABLE

    os.makedirs(data_dir, exist_ok=True)
    for seed, row in zip((21, 22, 23), CASE_TABLE[:3]):
        sio.savemat(os.path.join(data_dir, f"pat{row['pt_id'].split('-')[-1]}_mean_b0.mat"),
                    {"data_mean_b0": _b0_blob(seed)})


def phase_train_main(out_dir: str):
    """The MISR training path: ``train_misr.main`` at full width with
    ``--conv_kernel`` on three synthetic volumes; every launch count is set
    to 0 just before the run and read just after, each step's and each
    validation pass's launches recorded. Returns the launches and the
    training arrays."""
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch.cli import train_misr
    from mri_super_resolution_tpu_torch.config import RAMSConfig
    from mri_super_resolution_tpu_torch.fit.trainer import Trainer
    from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk
    from mri_super_resolution_tpu_torch.ops import wire_kernel as wk
    from mri_super_resolution_tpu_torch.pipelines import misr
    from mri_super_resolution_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                                 unwrap_trainer_params)

    data_dir = os.path.join(out_dir, "data")
    _write_b0_volumes(data_dir)
    counts = lambda: {**sk.LAUNCHES, **wk.LAUNCHES, **ck.LAUNCHES}
    steps, vals = [], []
    train_step, evaluate = Trainer.train_step, Trainer.evaluate

    def rec_step(self, micro):
        before = counts()
        out = train_step(self, micro)
        steps.append({k: v - before[k] for k, v in counts().items()})
        return out

    def rec_evaluate(self, x_val, *args, **kwargs):
        before = counts()
        out = evaluate(self, x_val, *args, **kwargs)
        n_batches = -(-len(x_val) // self.cfg.batch_size)
        vals.append(({k: v - before[k] for k, v in counts().items()}, n_batches))
        return out

    env = os.environ.get("MRI_SR_DATA_DIR")
    os.environ["MRI_SR_DATA_DIR"] = data_dir
    Trainer.train_step, Trainer.evaluate = rec_step, rec_evaluate
    ckpt, logs = os.path.join(out_dir, "ckpt"), os.path.join(out_dir, "logs")
    try:
        for mod in (sk, wk, ck):
            mod.reset_launches()
        t0 = time.perf_counter()
        trainer = train_misr.main([
            "--conv_kernel", "--batch_size", str(TRAIN_BATCH), "--hr_size", "96",
            "--epochs", "2", "--evaluate_every", "2", "--ckpt_dir", ckpt, "--log_dir", logs,
            "--device", "cuda", "--seed", "0"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        X, Y, M, pids = train_misr.build_dataset(hr_size=96)
        (Xt, Yt, Mt), _ = train_misr.split_dataset(X, Y, M, pids)
    finally:
        Trainer.train_step, Trainer.evaluate = train_step, evaluate
        if env is None:
            os.environ.pop("MRI_SR_DATA_DIR", None)
        else:
            os.environ["MRI_SR_DATA_DIR"] = env

    _require(trainer.state.step == TRAIN_STEPS and len(steps) == TRAIN_STEPS,
             f"{len(steps)} optimizer steps, expected {TRAIN_STEPS}")
    for i, d in enumerate(steps):
        for name, n in d.items():
            want = K6_PER_FORWARD if name in ("conv3d_rfab", "conv3d_rfab_bwd",
                                              "conv3d_rfab_wg") else 0
            _require(n == want, f"step {i + 1}: {name} launched {n} times, expected {want}")
    _require(len(vals) == TRAIN_VAL_PASSES, f"{len(vals)} validation passes")
    val_batches = sum(nb for _, nb in vals)
    for d, nb in vals:
        for name, n in d.items():
            want = K6_PER_FORWARD * nb if name in ("conv3d_rfab", "conv3d_rfab_wg") else 0
            _require(n == want, f"validation: {name} launched {n} times, expected {want}")
    for name, n in launches.items():
        want = {"conv3d_rfab": K6_PER_FORWARD * (TRAIN_STEPS + val_batches),
                "conv3d_rfab_wg": K6_PER_FORWARD * (TRAIN_STEPS + val_batches),
                "conv3d_rfab_bwd": K6_PER_FORWARD * TRAIN_STEPS}.get(name, 0)
        _require(n == want, f"{name} launched {n} times on the training path, expected {want}")
    rows = np.loadtxt(os.path.join(logs, "RAMS_scalars.csv"), delimiter=",", skiprows=1,
                      ndmin=2)
    _require(rows.shape == (2, 4) and bool(np.isfinite(rows).all()),
             f"the scalar CSV: {rows.tolist()}")
    cfg = RAMSConfig(conv_kernel=True)
    init = misr.build_rams(cfg, generator=torch.Generator().manual_seed(0))
    moved = max(float((p.detach().cpu() - init.state_dict()[k]).abs().max())
                for k, p in trainer.model.named_parameters())
    _require(moved > 0, "the params did not move")
    tree = CheckpointManager(ckpt).restore()
    _require(tree is not None and tree["step"] in (2, 4), "no checkpoint written")
    restored = misr.build_rams(cfg)
    restored.load_state_dict(unwrap_trainer_params(tree))
    val = float(rows[-1, 3])
    print(f"[main train] train_misr.main() {wall:.1f} s: {len(Xt)} train patches, "
          f"{TRAIN_STEPS} steps, {TRAIN_VAL_PASSES} validation passes ({val_batches} "
          f"batches); launches {launches}; CSV rows {rows.tolist()}; params moved by up to "
          f"{moved:.3e}; checkpoint at step {tree['step']} restored; val cPSNR {val:.2f}")
    return ({"conv3d_rfab_bwd": launches["conv3d_rfab_bwd"]}, (Xt, Yt, Mt))


def phase_train_step_times(data, out_dir: str) -> None:
    """One full step at batch 32 (forward, shift-L1, backward, Adam) with
    ``conv_kernel`` on and on the cuDNN route, bf16, from the same init;
    the same three steps also on the cuDNN route in float32: the two bf16
    routes' losses may differ by at most twice the cuDNN route's own
    bf16-vs-float32 gap (phase misr_main's bound). Steps timed on the host
    clock around a synchronised step, best of 3, routes in turns; then one
    step per route under the profiler."""
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch.config import RAMSConfig, TrainerConfig
    from mri_super_resolution_tpu_torch.fit.trainer import Trainer
    from mri_super_resolution_tpu_torch.pipelines import misr

    X, Y, M = data
    routes = {"conv_kernel": dict(conv_kernel=True), "cuDNN": {},
              "cuDNN float32": dict(compute_dtype="float32")}
    trainers, losses = {}, {}
    for name, kw in routes.items():
        model = misr.build_rams(RAMSConfig(**kw), generator=torch.Generator().manual_seed(0))
        trainers[name] = Trainer(model, TrainerConfig(batch_size=TRAIN_BATCH, hr_size=96,
                                                      checkpoint_dir=os.path.join(out_dir, name)),
                                 device="cuda")
        trainers[name].init()
        tr = trainers[name]
        losses[name] = np.asarray([float(tr.train_step([tr._batch(
            np.arange(i, i + TRAIN_BATCH) % len(X), X, Y, M)])[0]) for i in (0, 32, 16)])
    gap = float(np.abs(losses["conv_kernel"] - losses["cuDNN"]).max())
    own = float(np.abs(losses["cuDNN"] - losses["cuDNN float32"]).max())
    print(f"[train] loss over 3 steps: " + "; ".join(
        f"{k} {np.array2string(v, precision=3)}" for k, v in losses.items())
        + f"; routes differ by {gap:.4f}, cuDNN bf16 vs float32 by {own:.4f} "
          f"(tol: route gap <= 2x that)")
    _require(gap <= 2 * own, "the K6/K7 and cuDNN training routes differ beyond the bf16 bound")
    best = {}
    for name in ("conv_kernel", "cuDNN", "conv_kernel", "cuDNN"):
        tr = trainers[name]
        batch = tr._batch(np.arange(TRAIN_BATCH), X, Y, M)
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step([batch])
            torch.cuda.synchronize()
            best[name] = min(best.get(name, float("inf")), time.perf_counter() - t0)
    print(f"[times] train step, batch {TRAIN_BATCH}, bf16 (forward, shift-L1, backward, "
          f"Adam): conv_kernel {1e3 * best['conv_kernel']:.1f} ms, cuDNN "
          f"{1e3 * best['cuDNN']:.1f} ms")
    for name in ("conv_kernel", "cuDNN"):
        tr = trainers[name]
        batch = tr._batch(np.arange(TRAIN_BATCH), X, Y, M)
        _device_busy(f"train step, batch {TRAIN_BATCH}, bf16, {name}",
                     lambda: tr.train_step([batch]))


def _device_busy(what: str, fn) -> None:
    """One call of ``fn`` under ``torch.profiler``: the host clock around it
    (synchronised; the profiler's own cost included), the summed time of the
    device's kernels and the share of the call the device had no kernel
    running."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"[profile] {what}: no device events traced; idle share not measured")
        return
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"[profile] {what}: {wall_ms:.1f} ms on the host clock under the profiler, "
          f"{len(kernels)} device kernels busy {busy_ms:.1f} ms, device idle share "
          f"{1 - busy_ms / wall_ms:.3f}")


def _passes(what: str, fn, calls: int = 3) -> dict:
    """Where a call's device time goes: ``calls`` calls under
    ``torch.profiler``, each kernel's summed time per call, largest first
    (K1-K3's forward, last forward, chain, dW and dx passes are the
    ``wg_kernel`` templates 0-4, the second template argument the stash: 1
    float32, 0 the batched K1's bf16; K4's forward, dW and dh passes the
    ``wire_gemm_kernel`` templates 0, 2 and 3).
    Returns the ms a call by kernel name (empty when nothing was traced)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per_kernel: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = re.sub(r"\(.*$", "", re.sub(r"^void ", "", name))
            per_kernel[name] = per_kernel.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    if not per_kernel:
        print(f"[profile] {what} passes: no device events traced; not measured")
        return per_kernel
    print(f"[profile] {what} passes, ms a call (device total "
          f"{sum(per_kernel.values()):.3f}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(per_kernel.items(),
                                                         key=lambda kv: -kv[1])))
    return per_kernel


def phase_k7_times(err: float, launches: dict) -> dict:
    """K7 in bf16 at each training path shape: the kernel, its plain version
    and ``torch.autograd.grad`` through ``F.conv3d`` on the same channels-
    last bf16 tensors (dx, dW, db; the forward's graph kept), with CUDA
    events, beside the bound; K6 and ``F.conv3d`` forward at the same
    shapes for the step's share. Kernel and library in three alternating
    rounds, best of each. The kernels-line row is the SAME shape that runs
    25 of the 34 launches."""
    import torch
    import torch.nn.functional as F

    from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck

    row = None
    per_step = {"K7": 0.0, "cuDNN bwd": 0.0, "K6": 0.0, "cuDNN fwd": 0.0}
    for i, (shape, pad, n) in enumerate(TRAIN_SHAPES):
        x, w, g = _k7_inputs(shape, pad, torch.bfloat16, seed=100 + i)
        B, Ho, Wo, To = ck.out_shape(shape, pad)
        C = shape[-1]
        xl = x.permute(0, 4, 1, 2, 3).detach().requires_grad_()  # channels-last, no copy
        wl = w.bfloat16().permute(4, 3, 0, 1, 2).contiguous().requires_grad_()
        bl = torch.zeros(C, device="cuda", dtype=torch.bfloat16, requires_grad=True)
        out = F.conv3d(xl, wl, bl, padding=pad.lower())
        gl = g.permute(0, 4, 1, 2, 3)
        flops = 4 * B * Ho * Wo * To * 27 * C * C
        nbytes = 2 * (2 * x.numel() + g.numel() + w.numel()) + 4 * (w.numel() + C)
        r = _time_row("conv3d_rfab_bwd", "conv3d", "conv3d_kernel.py:234",
                      lambda: ck.conv3d_rfab_bwd(x, w, g, pad),
                      lambda: ck.conv3d_rfab_bwd_ref(x, w, g, pad),
                      lambda: torch.autograd.grad(out, (xl, wl, bl), gl, retain_graph=True),
                      flops, nbytes, f"{shape} {pad}", {"conv3d_rfab_bwd": err}, launches,
                      peak=PEAK_BF16_TC, reps=5, rounds=3)
        b = torch.zeros(C, device="cuda")
        with torch.no_grad():
            k6_ms, lib_ms = _best_alternating(
                lambda: ck.conv3d_rfab(x, w, b, pad),
                lambda: F.conv3d(xl, wl, bl, padding=pad.lower()), 5, 3)
        k6_bound = max(flops / 2 / PEAK_BF16_TC, (x.numel() + g.numel()) * 2 / PEAK_BYTES) * 1e3
        print(f"[times] conv3d_rfab {shape} {pad}: kernel {k6_ms:.3f} ms, F.conv3d "
              f"{lib_ms:.3f} ms, bound {k6_bound:.3f} ms; kernel/library "
              f"{k6_ms / lib_ms:.3f}, kernel/bound {k6_ms / k6_bound:.2f} "
              f"(K7's dx runs this kernel on g)")
        per_step["K6"] += n * k6_ms
        per_step["cuDNN fwd"] += n * lib_ms
        per_step["K7"] += n * r["ms"]
        per_step["cuDNN bwd"] += n * r["library_ms"]
        if row is None:
            row = r
        del x, g, xl, out, gl
    torch.cuda.empty_cache()
    print("[times] per train step (34 launches each): " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in per_step.items()))
    return row


def _expected_launches(inr_model: str, epochs: int, pn_epochs: int) -> dict:
    """Launches of each kernel of the path in one patient: every mean step
    (the first epochs - pn_epochs and the odd alternating epochs) is one
    K1 or K4; each even alternating epoch is one PN step per combination
    (75), a K3 forward and a K2 backward on the SIREN path; inference is 5 +
    2 chunks (1,120,000 and 280,000 rows at 262,144 a chunk). K1, K2 and K3
    run on their tensor-core route: the SIMT ones launch zero times."""
    n1 = epochs - pn_epochs
    odd = sum(e % 2 for e in range(n1, epochs))
    pn_steps = 75 * (pn_epochs - odd)
    if inr_model == "wire":
        return {"wire_loss_grads_tc": n1 + odd, "wire_forward_tc": 7}
    return {"siren_loss_grads_wg": n1 + odd, "siren_fused_bwd_wg": pn_steps,
            "siren_forward_wg": pn_steps + 7}


def _b0_volume(seed: int = 7):
    """A seeded smooth (128, 128, 28) blob of about 1000, float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x, y, z = np.meshgrid(np.linspace(-1, 1, 128), np.linspace(-1, 1, 128),
                          np.linspace(-1, 1, 28), indexing="ij")
    return (1000.0 * (np.exp(-(x ** 2 / 0.5 + y ** 2 / 0.3 + z ** 2))
                      + 0.05 * rng.random((128, 128, 28)))).astype(np.float32)


def _reference_patient(what: str):
    """The 3-D pipeline's synthetic patient: a mono-exponential hybrid of
    the (128, 128, 28) blob, acquisitions (1, 3, 5, 5); and its b-values."""
    import numpy as np

    from mri_super_resolution_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    hybrid = synthetic.hybrid_from_b0(_b0_volume(), acq_counts=(1, 3, 5, 5), seed=7)
    print(f"[main {what}] synthetic patient (128, 128, 28), acq (1, 3, 5, 5) "
          f"in {time.perf_counter() - t0:.1f} s")
    return hybrid, np.asarray(BVALS)


def _run_keep(cfg, hybrid, bv, out_dir: str, export_artifact: bool = False):
    """``superres3d.run`` on one patient with every launch count set to 0
    just before it; returns the patient's result, the wall seconds and the
    counts read just after."""
    import torch

    from mri_super_resolution_tpu_torch.pipelines import superres3d

    results = []
    run_patient = superres3d.run_patient

    def recording(*args, **kwargs):
        r = run_patient(*args, **kwargs)
        results.append(r)
        return r

    superres3d.run_patient = recording  # keep the result for the checks
    try:
        _reset_all_counts()
        t0 = time.perf_counter()
        superres3d.run([(0, hybrid, bv)], cfg, out_dir, seed=0, device="cuda",
                       export_artifact=export_artifact)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _all_counts()
    finally:
        superres3d.run_patient = run_patient
    (res,) = results
    return res, wall, launches


def _check_patient(res, out_dir: str, epochs: int, pn_epochs: int) -> np.ndarray:
    """run()'s CSV and timings.json, the volumes' shapes, finite clamped
    values, and a falling mean-fit loss; returns the SSIM rows."""
    import numpy as np

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
    _require(json.load(open(timings_path))["platform"] == "cuda", "timings.json platform")
    return ssim


def phase_main_path(inr_model: str, epochs: int, pn_epochs: int, out_dir: str):
    """The pipeline's run() on a full-width synthetic patient; returns the
    launches of this path's kernels, counted from 0 over this run only."""
    from mri_super_resolution_tpu_torch.config import SupperresDWIConfig

    hybrid, bv = _reference_patient(inr_model)
    cfg = SupperresDWIConfig(number_of_epochs=epochs, perturbation_epochs=pn_epochs,
                             inr_model=inr_model)
    res, wall, launches = _run_keep(cfg, hybrid, bv, out_dir)
    ssim = _check_patient(res, out_dir, epochs, pn_epochs)
    n1 = epochs - pn_epochs
    want = _expected_launches(inr_model, epochs, pn_epochs)
    for name, n in launches.items():
        _require(n == want.get(name, 0),
                 f"{name} launched {n} times on the {inr_model} path, expected "
                 f"{want.get(name, 0)}")
    for name in want:
        _require(launches[name] > 0, f"kernel {name} was not launched on the main path")
    timings = json.load(open(os.path.join(out_dir, "timings.json")))
    launches = {k: v for k, v in launches.items() if v}
    print(f"[main {inr_model}] run() {wall:.1f} s; launches {launches}; loss "
          f"{res.losses[0]:.4e} -> {res.losses[n1 - 1]:.4e}; mean SSIM spline "
          f"{ssim[:, 0].mean():.4f}, SR {ssim[:, 1].mean():.4f}")
    print(f"[main {inr_model}] phases {json.dumps(timings['patients'][0])}")
    return {name: launches[name] for name in want}


def _check_maps(maps, what: str) -> None:
    """Tissue maps of the (120, 120) slice: finite, D and T2 within the
    NLLS bounds, v summing to 1, the ADC finite, a boolean cancer map."""
    import numpy as np

    from mri_super_resolution_tpu_torch.ops.nlls import HI, LO

    for name, a in (("D", maps.D), ("T2", maps.T2), ("v", maps.v)):
        _require(a.shape == (120, 120, 3) and np.isfinite(a).all(), f"{what} {name} map")
    lo, hi = LO - 1e-5, HI + 1e-5
    _require(((maps.D >= lo[:3]) & (maps.D <= hi[:3])).all()
             and ((maps.T2 >= lo[3:6]) & (maps.T2 <= hi[3:6])).all(),
             f"{what} D/T2 outside the fit's bounds")
    _require(np.abs(maps.v.sum(-1) - 1.0).max() < 1e-5 and (maps.v[..., :2] >= -1e-6).all(),
             f"{what} v does not sum to 1")
    _require(np.isfinite(maps.adc).all() and maps.cancer.dtype == bool, f"{what} ADC/cancer")


def phase_hybrid(epochs: int) -> tuple[dict, object, object, object]:
    """The hybrid tissue fit at full width: ``fit_all_te`` (four SIRENs
    256 -> 512x4 -> 1 on P = 100,800 rows each, K1 on every step, K3 for
    inference) then ``tissue_maps`` with the NLLS (40 iterations) on the
    card, on a seeded three-compartment patient; returns the launches of
    the two K1 rows at this shape (batched, and the unbatched one's 0), the
    fit's result, the maps and the ground truth."""
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch.data import synthetic
    from mri_super_resolution_tpu_torch.pipelines import hybrid as hy

    t0 = time.perf_counter()
    hybrid_all, gt = synthetic.hybrid_from_tissue(_b0_volume(), seed=7)
    hybrid = hy.mean_over_acquisitions(hybrid_all)
    print(f"[main hybrid] synthetic tissue patient (128, 128, 28), acq (1, 3, 5, 5) in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = hy.HybridConfig(number_of_epochs=epochs)
    _reset_all_counts()
    t0 = time.perf_counter()
    res = hy.fit_all_te(hybrid, cfg, seed=0, device="cuda")
    t1 = time.perf_counter()
    maps = hy.tissue_maps(res, np.asarray(BVALS), _slice=HYBRID_SLICE,
                          nlls_iters=cfg.nlls_iters, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = _all_counts()
    chunks = -(-HYBRID_INFER // INFER_CHUNK)
    want = {"siren_loss_grads_wg_batched": epochs, "siren_forward_wg": HYBRID_TES * chunks}
    _check_only(launches, want, "hybrid")
    _require(res.timings["lr_voxels_per_te"] == HYBRID_P, "hybrid LR voxels")
    rh = res.recon_hybrid
    _require(rh.shape == (120, 120, 28, 4, 4) and np.isfinite(rh).all() and (rh >= 0).all(),
             "recon_hybrid shape, finite and >= 0")
    _require(np.isfinite(res.losses).all() and (res.losses[:, -1] < res.losses[:, 0]).all(),
             f"a per-TE loss did not fall: {res.losses[:, 0]} -> {res.losses[:, -1]}")
    _check_maps(maps, "NLLS")
    # the ground truth of the slice on the ROI, against the 2x maps at ::2
    v_gt = gt["v"][35:95, 35:95, HYBRID_SLICE]
    err = np.median(np.abs(maps.v[::2, ::2] - v_gt), axis=(0, 1))
    print(f"[main hybrid] fit_all_te {t1 - t0:.1f} s (phases {json.dumps(res.timings)}), "
          f"tissue_maps (NLLS, {cfg.nlls_iters} iterations, 14,400 voxels) {t2 - t1:.2f} s; "
          f"launches {want}; per-TE loss {res.losses[:, 0].round(5).tolist()} -> "
          f"{res.losses[:, -1].round(6).tolist()}; median |v - v_true| per compartment "
          f"{err.round(4).tolist()}; cancer-map fraction {float(maps.cancer.mean()):.4f}")
    # the hybrid's K1 rows, each from its own key: the batched entry, and
    # the unbatched entry at this shape (0, the path is batched)
    return ({"siren_loss_grads_wg_batched": launches["siren_loss_grads_wg_batched"],
             "siren_loss_grads_wg_hybrid": launches["siren_loss_grads_wg"]}, res, maps, gt)


def phase_pia(res, nlls_maps, gt, steps: int) -> None:
    """``make_pia_fitter`` pretrains ``steps`` steps on the card, then
    ``tissue_maps`` runs with it on the hybrid's result; no kernel."""
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch.pipelines import hybrid as hy

    _reset_all_counts()
    t0 = time.perf_counter()
    fitter = hy.make_pia_fitter(train_steps=steps, seed=0, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    maps = hy.tissue_maps(res, np.asarray(BVALS), _slice=HYBRID_SLICE, fitter=fitter,
                          device="cuda")
    t2 = time.perf_counter()
    _check_only(_all_counts(), {}, "pia")
    _check_maps(maps, "PIA")
    v_gt = gt["v"][35:95, 35:95, HYBRID_SLICE]
    err = np.median(np.abs(maps.v[::2, ::2] - v_gt), axis=(0, 1))
    gap = np.median(np.abs(maps.v - nlls_maps.v), axis=(0, 1))
    print(f"[main pia] make_pia_fitter {steps} steps {t1 - t0:.2f} s "
          f"({(t1 - t0) / steps * 1e3:.2f} ms a step), tissue_maps with it {t2 - t1:.3f} s; "
          f"median |v - v_true| {err.round(4).tolist()}, median |v - v_NLLS| "
          f"{gap.round(4).tolist()}")


def _grid_cfg(preset: str, epochs: int, pn_epochs: int):
    """The 3-D pipeline's config at ``preset``'s settings and the given
    schedule."""
    from mri_super_resolution_tpu_torch.config import PRESETS, SupperresDWIConfig

    fields = {k: v for k, v in PRESETS[preset].items()
              if k in SupperresDWIConfig.__dataclass_fields__}
    return SupperresDWIConfig(number_of_epochs=epochs, perturbation_epochs=pn_epochs, **fields)


def phase_grid(preset: str, epochs: int, pn_epochs: int, out_dir: str) -> None:
    """``superres3d.run`` with the grid INR at ``preset``'s settings
    (``quality`` and ``fast``: GridINR L4, base 6, F 4, hidden 64, z_divisor
    1, restart_adam(5e-3, 250)) for ``epochs`` of which ``pn_epochs``
    alternate, on the reference phase's patient: the CSV, timings.json, the
    volumes, and no kernel launched."""
    hybrid, bv = _reference_patient(f"grid {preset}")
    cfg = _grid_cfg(preset, epochs, pn_epochs)
    _require(cfg.inr_model == "grid" and cfg.inr_restart_every == 250, "preset fields")
    res, wall, launches = _run_keep(cfg, hybrid, bv, out_dir)
    _check_only(launches, {}, f"grid {preset}")
    ssim = _check_patient(res, out_dir, epochs, pn_epochs)
    timings = json.load(open(os.path.join(out_dir, "timings.json")))
    _require(timings["config"]["inr_model"] == "grid", "timings.json inr_model")
    print(f"[main grid {preset}] run() {wall:.1f} s ({epochs} epochs, {pn_epochs} alternating); "
          f"no kernel launched; loss {res.losses[0]:.4e} -> {res.losses[-1]:.4e}; mean SSIM "
          f"spline {ssim[:, 0].mean():.4f}, SR {ssim[:, 1].mean():.4f}")
    print(f"[main grid {preset}] phases {json.dumps(timings['patients'][0])}")


def phase_grid_trace() -> None:
    """GRID_TRACE_STEPS epochs (GRID_TRACE_PN alternating) at the quality
    preset from one init on the card and on the CPU, loss by loss, and the
    recon; then on the card with TF32 products, which must break the bars."""
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch import set_float32_precision
    from mri_super_resolution_tpu_torch.core.coords import fourier_matrix
    from mri_super_resolution_tpu_torch.models import PerturbNet
    from mri_super_resolution_tpu_torch.pipelines import superres3d

    hybrid, bv = _reference_patient("grid trace")
    cfg = _grid_cfg("quality", GRID_TRACE_STEPS, GRID_TRACE_PN)
    gen = torch.Generator().manual_seed(11)
    init = {"B": fourier_matrix(gen, cfg.mapping_size, 4).numpy(),
            "inr": superres3d._grid_model(cfg, gen).state_dict(),
            "pn": PerturbNet(4, cfg.pn_dim, 4, generator=gen).state_dict()}
    def gaps(run):
        return (float(np.max(np.abs(run.losses / cpu.losses - 1.0))),
                float(np.abs(run.recon_2x - cpu.recon_2x).max()))

    t0 = time.perf_counter()
    card = superres3d.run_patient(hybrid, bv, cfg, device="cuda", init=init)
    t1 = time.perf_counter()
    cpu = superres3d.run_patient(hybrid, bv, cfg, device="cpu", init=init)
    t2 = time.perf_counter()
    # the control: the same fit on the card as if run_patient left TF32 on
    def tf32_on():
        torch.backends.cuda.matmul.allow_tf32 = True

    superres3d.set_float32_precision = tf32_on
    try:
        tf32 = superres3d.run_patient(hybrid, bv, cfg, device="cuda", init=init)
    finally:
        superres3d.set_float32_precision = set_float32_precision
        set_float32_precision()
    rel, err = gaps(card)
    rel_tf32, err_tf32 = gaps(tf32)
    print(f"[parity] grid quality {GRID_TRACE_STEPS}-epoch trace ({GRID_TRACE_PN} alternating) "
          f"card vs CPU from one init: loss {cpu.losses[0]:.6e} -> {cpu.losses[-1]:.6e} (CPU), "
          f"{card.losses[-1]:.6e} (card); worst step rel {rel:.3e} (tol {GRID_TRACE_RTOL:g}); "
          f"recon max abs {err:.3e} (tol {GRID_RECON_ATOL:g}); card {t1 - t0:.1f} s, CPU "
          f"{t2 - t1:.1f} s; control with TF32 on: worst step rel {rel_tf32:.3e}, recon max "
          f"abs {err_tf32:.3e}")
    _require(rel <= GRID_TRACE_RTOL and err <= GRID_RECON_ATOL,
             "the grid fit on the card departs from the CPU's")
    _require(rel_tf32 > GRID_TRACE_RTOL or err_tf32 > GRID_RECON_ATOL,
             "the grid trace's bars do not see TF32 products")


def _hybrid_grid_cfg(epochs: int, restart_every: int | None = None):
    """The hybrid fit at the ``fast`` preset's settings (the grid arm,
    restart_adam(5e-3, 250)) for ``epochs``, the restart period optionally
    replaced."""
    from mri_super_resolution_tpu_torch.config import PRESETS
    from mri_super_resolution_tpu_torch.pipelines import hybrid as hy

    fields = {k: v for k, v in PRESETS["fast"].items()
              if k in hy.HybridConfig.__dataclass_fields__}
    cfg = hy.HybridConfig(number_of_epochs=epochs, **fields)
    _require(cfg.inr_model == "grid" and cfg.inr_restart_every == 250
             and cfg.grid_lr == 5e-3 and PRESETS["fast"]["epochs"] == 600, "fast preset fields")
    if restart_every is not None:
        cfg.inr_restart_every = restart_every
    return cfg


def _hybrid_grid_init(cfg, seed: int) -> dict:
    """One init of the four TEs' GridINRs (and the unused B), drawn on the
    CPU from ``seed``, as ``fit_all_te``'s ``init``."""
    import torch

    from mri_super_resolution_tpu_torch.core.coords import fourier_matrix
    from mri_super_resolution_tpu_torch.pipelines import hybrid as hy

    gen = torch.Generator().manual_seed(seed)
    return {"B": fourier_matrix(gen, cfg.mapping_size, 4).numpy(),
            "inr": [hy._hybrid_grid_model(cfg, 4, gen).state_dict() for _ in range(HYBRID_TES)]}


def _hybrid_grid_in_turn(hybrid, cfg, init: dict, device: str):
    """The grid arm's plain version: the four TEs' GridINRs from ``init``
    fitted one after another, each with its own ``restart_adam`` on the
    unbatched tensor path (the arm before it was batched); returns the (4,
    epochs) losses and the fit's seconds, timed as ``fit_all_te`` times its
    fit_s (from the targets on the device to the last step's end)."""
    import torch

    from mri_super_resolution_tpu_torch.core.coords import mgrid
    from mri_super_resolution_tpu_torch.models.grid_inr import make_tensor_value_and_grad
    from mri_super_resolution_tpu_torch.pipelines import hybrid as hy
    from mri_super_resolution_tpu_torch.pipelines.superres3d import _sync, normalize_hybrid

    dev = torch.device(device)
    normed, _ = normalize_hybrid(hybrid)
    lr_shape, targets = hy.te_targets(normed, cfg)
    targets = torch.as_tensor(targets, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    coords = mgrid(lr_shape, device=dev)
    vag = make_tensor_value_and_grad(lr_shape)
    losses = []
    for te in range(HYBRID_TES):
        model = hy._hybrid_grid_model(cfg, 4, None, dev)
        model.load_state_dict(init["inr"][te])
        model.requires_grad_(False)
        losses.append(hy._fit(model.params(), cfg.grid_lr, cfg, coords, targets[te], vag))
    losses = torch.stack(losses)
    _sync(dev)
    return losses.cpu().numpy(), time.perf_counter() - t0


def _hybrid_grid_patient():
    """The hybrid phase's seeded three-compartment patient, averaged over
    its acquisitions."""
    from mri_super_resolution_tpu_torch.data import synthetic
    from mri_super_resolution_tpu_torch.pipelines import hybrid as hy

    hybrid_all, _ = synthetic.hybrid_from_tissue(_b0_volume(), seed=7)
    return hy.mean_over_acquisitions(hybrid_all)


def phase_hybrid_grid(epochs: int) -> None:
    """The hybrid fit's grid arm at full width on the card: ``fit_all_te``
    at the ``fast`` preset's settings for ``epochs`` on the hybrid phase's
    patient, one batched fit over the four TEs (no hand kernel; the per-TE
    losses falling; a finite (120, 120, 28, 4, 4) recon >= 0); a
    HYBRID_GRID_TRACE-epoch trace from one init, card batched against CPU
    batched and against the four TEs in turn on the card; then fit_s
    batched against in turn at ``epochs``, alternating (batched, in turn,
    in turn, batched), the two batched runs held equal bit for bit."""
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch.pipelines import hybrid as hy

    t0 = time.perf_counter()
    hybrid = _hybrid_grid_patient()
    print(f"[main hybrid grid] synthetic tissue patient (128, 128, 28) in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = _hybrid_grid_cfg(epochs)
    _reset_all_counts()
    t0 = time.perf_counter()
    res = hy.fit_all_te(hybrid, cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_only(_all_counts(), {}, "hybrid grid")
    _require(res.timings["lr_voxels_per_te"] == HYBRID_P and res.timings["inr_model"] == "grid"
             and res.timings["platform"] == "cuda", "hybrid grid timings")
    rh = res.recon_hybrid
    _require(rh.shape == (120, 120, 28, 4, 4) and np.isfinite(rh).all() and (rh >= 0).all(),
             "hybrid grid recon_hybrid shape, finite and >= 0")
    _require(res.losses.shape == (HYBRID_TES, epochs) and np.isfinite(res.losses).all()
             and (res.losses[:, -1] < res.losses[:, 0]).all(),
             f"a per-TE grid loss did not fall: {res.losses[:, 0]} -> {res.losses[:, -1]}")
    print(f"[main hybrid grid] fit_all_te {wall:.1f} s ({epochs} epochs, fast preset, one "
          f"batched fit over {HYBRID_TES} TEs; phases {json.dumps(res.timings)}); no kernel "
          f"launched; per-TE loss {res.losses[:, 0].round(5).tolist()} -> "
          f"{res.losses[:, -1].round(7).tolist()}")

    tcfg = _hybrid_grid_cfg(HYBRID_GRID_TRACE, HYBRID_GRID_RESTART)
    init = _hybrid_grid_init(tcfg, seed=13)
    card = hy.fit_all_te(hybrid, tcfg, seed=0, device="cuda", init=init)
    cpu = hy.fit_all_te(hybrid, tcfg, seed=0, device="cpu", init=init)
    turn, _ = _hybrid_grid_in_turn(hybrid, tcfg, init, "cuda")
    rel_cpu = float(np.max(np.abs(card.losses / cpu.losses - 1.0)))
    err_cpu = float(np.abs(card.recon_hybrid - cpu.recon_hybrid).max()
                    / np.abs(cpu.recon_hybrid).max())
    rel_turn = float(np.max(np.abs(card.losses / turn - 1.0)))
    print(f"[parity] hybrid grid {HYBRID_GRID_TRACE}-epoch trace (restarts every "
          f"{HYBRID_GRID_RESTART}) from one init: loss {cpu.losses[:, 0].round(6).tolist()} -> "
          f"{cpu.losses[:, -1].round(7).tolist()} (CPU); card batched vs CPU batched worst step "
          f"rel {rel_cpu:.3e} (tol {HYBRID_GRID_TRACE_RTOL:g}), recon max abs over its largest "
          f"{err_cpu:.3e} (tol {HYBRID_GRID_RECON_TOL:g}; largest "
          f"{float(np.abs(cpu.recon_hybrid).max()):.1f}); card batched vs the four TEs in turn on the "
          f"card worst step rel {rel_turn:.3e} (tol {HYBRID_GRID_TURN_RTOL:g})")
    _require(rel_cpu <= HYBRID_GRID_TRACE_RTOL and err_cpu <= HYBRID_GRID_RECON_TOL,
             "the batched grid fit on the card departs from the CPU's")
    _require(rel_turn <= HYBRID_GRID_TURN_RTOL,
             "the batched grid fit departs from the four TEs fitted in turn")

    phase_hybrid_grid_times(hybrid, cfg)


def phase_hybrid_grid_times(hybrid, cfg, profile_steps: int = 50) -> None:
    """fit_s of the grid arm at ``cfg``'s schedule from one init, batched
    (``fit_all_te``) against the four TEs in turn, alternating (batched, in
    turn, in turn, batched); the two batched runs held equal bit for bit.
    Then ``profile_steps`` batched steps and as many steps of each TE in
    turn under ``torch.profiler``: device kernels a step, busy time and idle
    share."""
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch.core.coords import mgrid
    from mri_super_resolution_tpu_torch.fit.engine import fit_simple_batched
    from mri_super_resolution_tpu_torch.fit.optim import StackedAdam
    from mri_super_resolution_tpu_torch.models.grid_inr import (
        make_tensor_value_and_grad,
        make_tensor_value_and_grad_batched,
    )
    from mri_super_resolution_tpu_torch.pipelines import hybrid as hy
    from mri_super_resolution_tpu_torch.pipelines.superres3d import normalize_hybrid

    epochs = cfg.number_of_epochs
    init = _hybrid_grid_init(cfg, seed=17)
    batched, in_turn = [], []
    for order in ("batched", "in turn", "in turn", "batched"):
        if order == "batched":
            batched.append(hy.fit_all_te(hybrid, cfg, seed=0, device="cuda", init=init))
        else:
            in_turn.append(_hybrid_grid_in_turn(hybrid, cfg, init, "cuda"))
    same = (np.array_equal(batched[0].losses, batched[1].losses)
            and np.array_equal(batched[0].recon_hybrid, batched[1].recon_hybrid))
    rel_long = float(np.max(np.abs(batched[0].losses / in_turn[0][0] - 1.0)))
    fit_b = [r.timings["fit_s"] for r in batched]
    fit_t = [t for _, t in in_turn]
    print(f"[times] hybrid grid fit_s at {epochs} epochs (fast preset's settings), batched "
          f"{fit_b[0]:.3f} / {fit_b[1]:.3f} s against in turn {fit_t[0]:.3f} / {fit_t[1]:.3f} s "
          f"(order batched, in turn, in turn, batched); batched / in turn "
          f"{min(fit_b) / min(fit_t):.3f}; {1e3 * min(fit_b) / epochs:.3f} ms a batched step "
          f"against {1e3 * min(fit_t) / epochs / HYBRID_TES:.3f} ms a TE's step in turn; "
          f"the two batched runs equal bit for bit: {same}; batched vs in turn worst step rel "
          f"over {epochs} epochs {rel_long:.3e} (printed, not bounded: the fits' chaos); "
          f"{_card()}")
    _require(same, "two batched grid fits from one init on the card differ")

    normed, _ = normalize_hybrid(hybrid)
    lr_shape, targets = hy.te_targets(normed, cfg)
    targets = torch.as_tensor(targets, device="cuda")
    coords = mgrid(lr_shape, device="cuda")
    models = []
    for sd in init["inr"]:
        m = hy._hybrid_grid_model(cfg, 4, None, "cuda")
        m.load_state_dict(sd)
        m.requires_grad_(False)
        models.append(m)
    opt = StackedAdam([torch.stack(ps) for ps in zip(*(m.params() for m in models))],
                      cfg.grid_lr, restart_every=cfg.inr_restart_every)
    vag_b, vag = make_tensor_value_and_grad_batched(lr_shape), make_tensor_value_and_grad(lr_shape)
    fit_simple_batched(opt, coords, targets, 2, vag_b)  # warm
    _passes(f"hybrid grid batched step over {HYBRID_TES} TEs",
            lambda: fit_simple_batched(opt, coords, targets, 1, vag_b), calls=10)
    _passes("hybrid grid step of one TE in turn",
            lambda: hy._fit(models[0].params(), cfg.grid_lr, _hybrid_grid_cfg(1, 0), coords,
                            targets[0], vag), calls=10)
    _device_busy(f"hybrid grid, {profile_steps} batched steps over {HYBRID_TES} TEs",
                 lambda: fit_simple_batched(opt, coords, targets, profile_steps, vag_b))
    cfg_n = _hybrid_grid_cfg(profile_steps, cfg.inr_restart_every)
    _device_busy(f"hybrid grid, {profile_steps} steps of each of {HYBRID_TES} TEs in turn",
                 lambda: [hy._fit(m.params(), cfg.grid_lr, cfg_n, coords, targets[te], vag)
                          for te, m in enumerate(models)])


def _card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def phase_autodiff() -> None:
    """``core/autodiff.py`` on the flagship SIREN (256 -> 512x4 -> 1 behind a
    128-mapping Fourier encoding of 4-D coordinates): the gradient and the
    Laplacian at AUTODIFF_P points on the card against the CPU."""
    import torch

    from mri_super_resolution_tpu_torch.core.autodiff import gradient, laplace
    from mri_super_resolution_tpu_torch.core.coords import fourier_encode, fourier_matrix
    from mri_super_resolution_tpu_torch.models import Siren

    gen = torch.Generator().manual_seed(71)
    B = fourier_matrix(gen, 128, 4)
    siren = Siren(256, 512, 3, generator=gen).requires_grad_(False)
    coords = torch.rand(AUTODIFF_P, 4, generator=gen) * 2 - 1
    out, walls = {}, {}
    for dev in ("cuda", "cpu"):
        model, Bd, c = siren.to(dev), B.to(dev), coords.to(dev)
        f = lambda x: model(fourier_encode(x, Bd))  # noqa: E731
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[dev] = (gradient(f, c), laplace(f, c))
        torch.cuda.synchronize()
        walls[dev] = time.perf_counter() - t0
    rels = [_rel(a.cpu(), b)[1] for a, b in zip(out["cuda"], out["cpu"])]
    print(f"[parity] autodiff of the flagship SIREN at {AUTODIFF_P} points, card vs CPU: "
          f"gradient rel {rels[0]:.3e}, Laplacian rel {rels[1]:.3e} (tol {AUTODIFF_TOL:g}); "
          f"card {walls['cuda']:.3f} s, CPU {walls['cpu']:.3f} s")
    _require(max(rels) <= AUTODIFF_TOL, "the INR operators on the card depart from the CPU's")


def phase_serve(out_dir: str) -> None:
    """``serve.py`` at full width on the card: a SIREN 256 -> 512x4 -> 1
    behind a 128-mapping Fourier encoding of 4-D coordinates, a WIRE 4 ->
    256x2 -> 1, a GridINR at the quality preset's widths, a PIA (S = 16) and
    the committed RAMS at 96 x 96 in bf16, each exported on the card (a cuda
    and a cpu program), loaded back on both devices and served: against the
    live module on the card at the CLI's bars (batch 1 included), the cuda
    program against the cpu one. Then the served SIREN on a 262,144-row
    chunk against the live plain SIREN and K3 on the same chunk, and the
    served RAMS's 25-draw forward against the live library route and the
    K6 route, with CUDA events."""
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch import convert, serve
    from mri_super_resolution_tpu_torch.config import RAMSConfig
    from mri_super_resolution_tpu_torch.core.coords import fourier_encode, fourier_matrix
    from mri_super_resolution_tpu_torch.models import PIA, Siren, Wire
    from mri_super_resolution_tpu_torch.models.grid_inr import infer_tensor_grid
    from mri_super_resolution_tpu_torch.models.rams import fold_weight_norm
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk
    from mri_super_resolution_tpu_torch.pipelines import superres3d
    from mri_super_resolution_tpu_torch.pipelines.misr import build_rams

    gen = torch.Generator().manual_seed(61)
    B = fourier_matrix(gen, 128, 4, device="cuda")
    siren = Siren(256, 512, 3, generator=gen, device="cuda")
    wire = Wire(4, 256, 2, generator=gen, device="cuda")
    grid = superres3d._grid_model(_grid_cfg("quality", 1, 0), gen, "cuda")
    pia = PIA(generator=gen, device="cuda")
    rams_sd = fold_weight_norm(convert.rams_state_dict(
        convert.load_params_npz(convert.RAMS_PARAMS_NPZ)))
    rams, rams_k6 = (build_rams(RAMSConfig(conv_kernel=k), device="cuda") for k in (False, True))
    for m in (rams, rams_k6):
        m.load_state_dict(rams_sd)
    for m in (siren, wire, grid, pia, rams, rams_k6):
        m.requires_grad_(False)
    with torch.no_grad():  # the grids start in [0, 1e-4): spread them over the output
        for g in grid.grids:
            g.mul_(1e4)
    uniform = lambda *shape, lo=-1.0, hi=1.0: (  # noqa: E731
        lo + (hi - lo) * torch.rand(*shape, generator=gen)).cuda()
    hr_axes = [torch.as_tensor(np.linspace(-1, 1, n), dtype=torch.float32, device="cuda")
               for n in (50, 50, 28)]
    x2_axes = [torch.as_tensor(np.linspace(-1, 1, n), dtype=torch.float32, device="cuda")
               for n in (100, 100, 28)]
    one_axes = [torch.zeros(1, device="cuda")] * 3
    S = SERVE_RAMS_SIDE
    x25 = uniform(SERVE_RAMS_DRAWS, S, S, 9, lo=0.0, hi=5000.0)
    def grid_live(*axes):
        shape = [len(a) for a in axes] + [4]
        return torch.as_tensor(infer_tensor_grid(grid.params(), shape, clamp_min=0.0)
                               ).reshape(*shape, 1)

    pts = {d: [[uniform(1, d, lo=lo, hi=hi)], [uniform(4099, d, lo=lo, hi=hi)]]
           for d, lo, hi in ((4, -1.0, 1.0), (16, 0.0, 1000.0))}
    # kind: (export, live module, inputs on the card, inputs for the cpu program, bar);
    # the RAMS's cpu program at one draw (bf16 convs on the host are slow)
    kinds = {
        "siren": (lambda: serve.export_inr(siren, 4, os.path.join(out_dir, "siren"),
                                           fourier_B=B, device="cuda",
                                           model_desc="siren 512x3 FF128"),
                  lambda c: siren(fourier_encode(c, B)), pts[4], pts[4], SERVE_TOL),
        "wire": (lambda: serve.export_inr(wire, 4, os.path.join(out_dir, "wire"), device="cuda"),
                 wire,
                 pts[4], pts[4], SERVE_TOL),
        "grid": (lambda: serve.export_grid_inr(grid, os.path.join(out_dir, "grid"),
                                                device="cuda"),
                 grid_live, [one_axes, hr_axes, x2_axes], [one_axes, hr_axes], SERVE_TOL),
        "pia": (lambda: serve.export_pia(pia, os.path.join(out_dir, "pia"), device="cuda"),
                pia.encode,
                pts[16], pts[16], SERVE_TOL),
        "rams": (lambda: serve.export_rams(rams, os.path.join(out_dir, "rams"), height=S,
                                           width=S, device="cuda"),
                 rams, [[x25[:1]], [x25]], [[x25[:1]]], SERVE_RAMS_TOL),
    }

    def rel(got, want):
        pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
        return max(_rel(g.float().cpu(), w.float().cpu())[1] for g, w in pairs)

    served = {}
    for kind, (export, live, inputs, cpu_inputs, tol) in kinds.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        manifest = export()
        t_export = time.perf_counter() - t0
        _require(manifest["platforms"] == ["cuda", "cpu"], f"{kind} artifact platforms")
        on = {dev: serve.load(os.path.join(out_dir, kind), device=dev) for dev in ("cuda", "cpu")}
        served[kind] = on["cuda"]
        with torch.no_grad():
            live_errs = [rel(on["cuda"](*args), live(*args)) for args in inputs]
            xdev_errs = [rel(on["cuda"](*args), on["cpu"](*(a.cpu() for a in args)))
                         for args in cpu_inputs]
        shapes = [list(a.shape) for a in inputs[-1]]
        print(f"[parity] served {kind}: export {t_export:.2f} s (cuda + cpu programs); "
              f"in {manifest['in_avals']} -> out {manifest['out_avals']}; served vs live on "
              f"the card at batches {[a[0].shape[0] for a in inputs]} (last {shapes}): worst "
              f"rel {max(live_errs):.3e}; cuda vs cpu program {max(xdev_errs):.3e} (tol "
              f"{tol:g})")
        _require(max(live_errs) <= tol, f"the served {kind} departs from the live module")
        _require(max(xdev_errs) <= tol, f"the {kind} artifact's cuda and cpu programs differ")

    chunk = uniform(INFER_CHUNK, 4)
    ws = siren.weights()
    with torch.no_grad():
        t_served = _time_ms(lambda: served["siren"](chunk), 10)
        t_live = _time_ms(lambda: siren(fourier_encode(chunk, B)), 10)
        t_k3 = _time_ms(lambda: sk.siren_forward(fourier_encode(chunk, B), ws), 10)
        k3_err = _rel(served["siren"](chunk), sk.siren_forward(fourier_encode(chunk, B), ws))[1]
        r_served = _time_ms(lambda: served["rams"](x25), 5)
        r_live = _time_ms(lambda: rams(x25), 5)
        r_k6 = _time_ms(lambda: rams_k6(x25), 5)
    card = _card()
    print(f"[times] served SIREN (256 -> 512x4 -> 1, 128 mappings, encoding included) on "
          f"{INFER_CHUNK} rows: served {t_served:.3f} ms, live plain {t_live:.3f} ms, K3 "
          f"{t_k3:.3f} ms (served/K3 {t_served / t_k3:.2f}; served vs K3 rel {k3_err:.2e}); "
          f"{card}")
    print(f"[times] served RAMS ({SERVE_RAMS_DRAWS} draws, {S} x {S}, bf16): served "
          f"{r_served:.3f} ms, live library route {r_live:.3f} ms, K6 route {r_k6:.3f} ms "
          f"(served/K6 {r_served / r_k6:.2f}); {card}")


def phase_export_main(epochs: int, pn_epochs: int) -> None:
    """``superres3d.run`` with ``export_artifact=True`` on the reference
    patient at the ``reference`` and ``quality`` presets (``epochs``,
    ``pn_epochs``): the launches exactly as without the export (it adds
    none), then ``pat0/artifact`` loaded on the card and served on the HR
    grid against the fitted INR on the pipeline's inference route (K3 for
    SIREN, the tensor path for the grid)."""
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch import serve
    from mri_super_resolution_tpu_torch.core.coords import mgrid
    from mri_super_resolution_tpu_torch.pipelines import superres3d

    hybrid, bv = _reference_patient("export")
    for preset in ("reference", "quality"):
        cfg = _grid_cfg(preset, epochs, pn_epochs)
        with tempfile.TemporaryDirectory() as out_dir:
            res, wall, launches = _run_keep(cfg, hybrid, bv, out_dir, export_artifact=True)
            want = ({} if cfg.inr_model == "grid"
                    else _expected_launches(cfg.inr_model, epochs, pn_epochs))
            _check_only(launches, want, f"{preset} export")
            served = serve.load(os.path.join(out_dir, "pat0", "artifact"), device="cuda")
            hr_shape = res.sr_hr_grid.shape
            with torch.no_grad():
                if cfg.inr_model == "grid":
                    axes = [torch.as_tensor(np.linspace(-1, 1, n), dtype=torch.float32,
                                            device="cuda") for n in hr_shape[:3]]
                    got = served(*axes).reshape(-1, 1)
                    ref = res.sr_hr_grid.reshape(-1, 1)
                    route = "the tensor path"
                else:
                    got = served(mgrid(hr_shape, device="cuda"))
                    ref = superres3d._route(cfg, res.inr, torch.as_tensor(
                        res.B, device="cuda")).infer(hr_shape)  # K3, unclamped as served
                    route = "K3"
            err = _rel(got.cpu(), torch.as_tensor(ref))[1]
        print(f"[main export {preset}] run(export_artifact=True) {wall:.1f} s; artifact "
              f"{served.manifest['kind']} {served.manifest['in_avals']}; served on the HR grid "
              f"{list(hr_shape)} vs {route}: rel {err:.3e} (tol {EXPORT_TOL:g}); launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        _require(err <= EXPORT_TOL, f"the {preset} artifact departs from the fitted INR")
        _require(served.manifest["maxes"] == np.asarray(res.maxes).tolist(), "manifest maxes")


def phase_qual(out_dir: str) -> None:
    """``qual_study.build_panel`` at full width on the card: one synthetic
    128 x 128 case of 9 acquisitions (``cli/inr_erd.build_cases``),
    SirenERD 128x3, phase 1 to 2e-5 on the 64 x 64 LR rows, 500 fine-tune
    steps; every launch count set to 0 just before and read just after:
    one streaming K1-a a phase-1 step, no other kernel. Phase 1, the
    fine-tune, the reconstruction and the scoring timed on the host clock,
    synchronised; the panel scored on the card and on the CPU."""
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch.cli.inr_erd import build_cases
    from mri_super_resolution_tpu_torch.ops.perceptual import score_panel
    from mri_super_resolution_tpu_torch.pipelines import qual_study

    data_dir = os.path.join(out_dir, "data")
    _write_2d_volume(data_dir, seed=45, erd_map=False)
    (case,) = build_cases(1, 9, data_dir)
    fit_until, recon_mean = qual_study.fit_until, qual_study.recon_mean
    marks, steps = {}, []

    def timed_fit(*args, **kwargs):
        torch.cuda.synchronize()
        marks["fit"] = time.perf_counter()
        res = fit_until(*args, **kwargs)
        torch.cuda.synchronize()
        marks["tune"] = time.perf_counter()
        steps.append(res.steps)
        return res

    def timed_recon(*args, **kwargs):
        torch.cuda.synchronize()
        marks["recon"] = time.perf_counter()
        return recon_mean(*args, **kwargs)

    qual_study.fit_until, qual_study.recon_mean = timed_fit, timed_recon
    try:
        _reset_all_counts()
        panel = qual_study.build_panel(case, case.cancer_slice, seed=QUAL_SEED,
                                       fine_tune_steps=QUAL_FINE_TUNE, device="cuda")
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = _all_counts()
    finally:
        qual_study.fit_until, qual_study.recon_mean = fit_until, recon_mean
    (n1,) = steps
    _check_only(launches, {"siren_loss_grads_absmax_stream": n1}, "qual panel")
    _require(0 < n1 < qual_study.PRETRAIN_MAX_STEPS, "the panel's phase 1 did not converge")
    _require(panel.low.shape == (LOWRES_SIDE, LOWRES_SIDE)
             and panel.sr.shape == (ERD_SIDE, ERD_SIDE), "panel shapes")
    _require(all(np.isfinite(getattr(panel, k)).all() for k in
                 ("low", "interpolated", "sr", "base", "adc_low", "adc_interpolated",
                  "adc_sr", "adc_base")), "non-finite panel arrays")
    _require(sorted(panel.order) == sorted(qual_study.ARMS), "arm order")

    peak = panel.base.max() + 1e-7
    quads = [panel.base * 255.0 / peak, panel.interpolated * 255.0 / peak,
             panel.sr * 255.0 / peak]
    scores, walls = {}, {}
    for dev in ("cuda", "cpu"):
        score_panel(*quads, device=dev)  # first-call set-up out of the timing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores[dev] = score_panel(*quads, device=dev)
        torch.cuda.synchronize()
        walls[dev] = time.perf_counter() - t0
    worst64 = max(abs(scores["cuda"][k] - scores["cpu"][k]) / max(abs(scores["cpu"][k]), 1e-30)
                  for k in scores["cpu"] if not k.startswith("SSIM"))
    worst_ssim = max(abs(scores["cuda"][k] - scores["cpu"][k]) for k in scores["cpu"]
                     if k.startswith("SSIM"))
    csv = qual_study.score_panels({QUAL_SEED: panel}, os.path.join(out_dir, "scores.csv"),
                                  device="cuda")
    rows = open(csv).read().splitlines()
    _require(len(rows) == 2 and rows[0].split(",")[0] == "file", "scores CSV")
    phase1, tune = marks["tune"] - marks["fit"], marks["recon"] - marks["tune"]
    recon = t_end - marks["recon"]
    print(f"[main qual] build_panel at 128 x 128, 9 acquisitions: phase 1 to loss <= "
          f"{ERD_THRESHOLD:g} in {n1} steps on {LOWRES_SIDE * LOWRES_SIDE} rows, {phase1:.3f} s "
          f"({1e3 * phase1 / n1:.3f} ms a step); fine-tune {QUAL_FINE_TUNE} steps "
          f"{tune:.3f} s ({1e3 * tune / QUAL_FINE_TUNE:.3f} ms a step, soft-ERD weights "
          f"included); reconstruction and ADC {recon:.3f} s; launches "
          f"{{'siren_loss_grads_absmax_stream': {n1}}}; order {[str(a) for a in panel.order]}; "
          f"{_card()}")
    print(f"[parity] qual panel scores, card vs CPU: float64 keys worst rel {worst64:.3e} (tol "
          f"{PERCEPTUAL_RTOL:g}), SSIM keys worst abs {worst_ssim:.3e} (tol "
          f"{PERCEPTUAL_SSIM_ATOL:g}); score_panel {walls['cuda']:.3f} s on the card, "
          f"{walls['cpu']:.3f} s on the CPU; FSIM_SR {scores['cuda']['FSIM_SR']:.5f}, "
          f"FSIM_interp {scores['cuda']['FSIM_interp']:.5f}")
    _require(worst64 <= PERCEPTUAL_RTOL and worst_ssim <= PERCEPTUAL_SSIM_ATOL,
             "the panel's scores on the card depart from the CPU's")


# ---------------------------------------------------------------------------
# the cohort runner, the parallel layer and the loaders
# ---------------------------------------------------------------------------


def _write_cohort_volumes(data_dir: str, n: int = COHORT_CASES) -> list[str]:
    """``n`` seeded (128, 128, 24) mean-b0 volumes, unit-scaled, with ERD
    maps, as the first ``n`` CASE_TABLE patients' files (scipy, v5); returns
    the paths written."""
    import numpy as np
    import scipy.io as sio

    from mri_super_resolution_tpu_torch.data import CASE_TABLE

    os.makedirs(data_dir, exist_ok=True)
    paths = []
    for seed, row in enumerate(CASE_TABLE[:n], start=31):
        no = row["pt_id"].split("-")[-1]
        b0 = _b0_blob(seed)
        paths.append(os.path.join(data_dir, f"pat{no}_mean_b0.mat"))
        sio.savemat(paths[-1], {"data_mean_b0": b0 / float(b0.max())})
        paths.append(os.path.join(data_dir, f"pat{no}_ERD.mat"))
        sio.savemat(paths[-1], {"ADC_alldata_mm_ERD": np.random.default_rng(seed).uniform(
            0, 3, b0.shape).astype(np.float32)})
    return paths


def phase_loaders(out_dir: str) -> None:
    """The loaders on this machine: a v5 file (numeric, cell, struct, char)
    through ``load_mat(prefer_native=True)`` against scipy, its decode on
    the prefetch pool, and ``load_cases`` over the cohort's registry files
    against scipy. Prints whether the C++ reader was used (without g++ or
    zlib the loaders read with scipy, the JAX package's host-IO fallback)."""
    import numpy as np
    import scipy.io as sio

    from mri_super_resolution_tpu_torch.data import load_cases, load_mat, native_io

    rng = np.random.default_rng(41)
    cell = np.empty((1, 2), dtype=object)
    cell[0, 0], cell[0, 1] = rng.normal(size=(4, 3)), np.arange(8.0).reshape(2, 2, 2)
    vol = rng.normal(size=(128, 128, 24)).astype(np.float32)
    path = os.path.join(out_dir, "loaders.mat")
    sio.savemat(path, {"vol": vol, "cell": cell, "rec": {"a": np.eye(3)}, "name": "dwi"})
    used = native_io.available()
    t0 = time.perf_counter()
    got = load_mat(path, prefer_native=True)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = sio.loadmat(path)
    t_scipy = time.perf_counter() - t0
    _require(np.array_equal(np.asarray(got["vol"], np.float32), ref["vol"]), "vol differs")
    _require(np.array_equal(np.asarray(got["cell"][0][0], np.float64), ref["cell"][0, 0]),
             "cell differs")
    _require(np.array_equal(np.asarray(got["rec"]["a"][0, 0], np.float64), np.eye(3)),
             "struct differs")
    _require(str(np.asarray(got["name"]).reshape(-1)[0]) == "dwi", "char differs")
    data_dir = os.path.join(out_dir, "registry")
    paths = _write_cohort_volumes(data_dir)
    if used:
        pf = native_io.Prefetcher()
        for p, h in [(p, pf.submit(p)) for p in paths]:
            arrays = pf.get(h)
            for k, v in sio.loadmat(p).items():
                if not k.startswith("__"):
                    _require(np.array_equal(arrays[k], v.astype(np.float64)), f"{p}: {k}")
    t0 = time.perf_counter()
    cases = load_cases(data_dir=data_dir)
    t_cases = time.perf_counter() - t0
    _require(len(cases) == COHORT_CASES, f"{len(cases)} cases loaded")
    for case in cases:
        want = sio.loadmat(os.path.join(data_dir, f"pat{case.pt_no}_mean_b0.mat"))
        _require(np.array_equal(case.b0, want["data_mean_b0"]), f"{case.pt_id}: b0 differs")
    print(f"[loaders] native reader {'used' if used else 'unavailable: scipy read'}; "
          f"a (128, 128, 24) volume + cell + struct + char: load_mat(prefer_native=True) "
          f"{t_native * 1e3:.1f} ms, scipy {t_scipy * 1e3:.1f} ms, equal; load_cases of "
          f"{len(cases)} cases{' through the prefetch pool' if used else ''} "
          f"{t_cases * 1e3:.1f} ms, equal to scipy")


def phase_cohort(out_dir: str) -> None:
    """``cli.cohort_run.main`` at full width (Siren 64x6, ROI 40:100, 1000
    steps, uncut) on four synthetic registry cases on the card: every case's
    loss falls, every recon is finite, no kernel launches (the cohort fit is
    plain autodiff, as in the JAX package); then a 20-step trace of the same
    cases from one injected init on the card against the CPU, loss by loss."""
    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch.cli import cohort_run
    from mri_super_resolution_tpu_torch.data import load_cases, native_io
    from mri_super_resolution_tpu_torch.models import Siren
    from mri_super_resolution_tpu_torch.pipelines import cohort

    data_dir = os.path.join(out_dir, "cohort")
    _write_cohort_volumes(data_dir)
    _reset_all_counts()
    t0 = time.perf_counter()
    res = cohort_run.main(["--steps", str(COHORT_STEPS), "--data_dir", data_dir,
                           "--device", "cuda"])
    wall = time.perf_counter() - t0
    _check_only(_all_counts(), {}, "cohort")
    _require(res.losses.shape == (COHORT_CASES, COHORT_STEPS), f"losses {res.losses.shape}")
    _require(res.recons.shape == (COHORT_CASES, 60, 60) and bool(np.isfinite(res.recons).all()),
             "recons not finite or of the wrong shape")
    _require(bool((res.losses[:, -1] < res.losses[:, 0]).all()),
             f"a case's loss did not fall: {res.losses[:, [0, -1]].tolist()}")
    cases = load_cases(data_dir=data_dir)
    init = []
    for s in cohort.case_seeds(0, len(cases)):
        m = Siren(2, 64, 6, 1, generator=torch.Generator().manual_seed(s))
        init.append([w.detach() for w in m.weights()])
    kw = dict(num_steps=COHORT_TRACE_STEPS, init_params=init)
    card = cohort.run_cohort(cases, device="cuda", **kw)
    cpu = cohort.run_cohort(cases, device="cpu", **kw)
    rel = float(np.max(np.abs(card.losses - cpu.losses) / np.abs(cpu.losses)))
    _require(rel <= COHORT_TRACE_RTOL, f"cohort trace card vs CPU: worst step rel {rel:.3e}")
    print(f"[cohort] cohort_run.main() {wall:.2f} s: {COHORT_CASES} cases x {COHORT_STEPS} "
          f"steps on mesh {res.mesh_shape}, {res.voxels_per_sec:,.0f} voxels/s; losses "
          f"{res.losses[:, 0].round(5).tolist()} -> {res.losses[:, -1].round(6).tolist()}; "
          f"no kernel launched; native reader {'used' if native_io.available() else 'unavailable'}"
          f"; {COHORT_TRACE_STEPS}-step trace card vs CPU worst step rel {rel:.2e} (bar "
          f"{COHORT_TRACE_RTOL:g}); card {card.voxels_per_sec:,.0f} voxels/s, CPU "
          f"{cpu.voxels_per_sec:,.0f}")


def phase_examples(out_dir: str) -> None:
    """The port's three examples on the card, each run's launches counted
    from 0: ``phantom_sanity`` as it stands (its gates raise on failure;
    one streaming K1-a launch a phase-1 step of the two phantoms' LR
    slices), ``sr3d_demo --epochs 60`` (the SIREN 128 -> 256x3 -> 1 on
    K1-K3's tensor-core route) and ``wire_vs_siren --steps 100`` (autograd
    over the plain models, as the JAX example: no kernel)."""
    import math

    import numpy as np
    import torch

    from mri_super_resolution_tpu_torch.examples import phantom_sanity, sr3d_demo, wire_vs_siren
    from mri_super_resolution_tpu_torch.pipelines import lowres_qual

    steps, run_slice = [], lowres_qual.run_slice

    def recording(*args, **kwargs):
        res = run_slice(*args, **kwargs)
        steps.append(res.pretrain_steps)
        return res

    lowres_qual.run_slice = recording
    try:
        _reset_all_counts()
        t0 = time.perf_counter()
        rows = phantom_sanity.main(["--out_dir", os.path.join(out_dir, "phantom_sanity")])
        wall = time.perf_counter() - t0
    finally:
        lowres_qual.run_slice = run_slice
    _check_only(_all_counts(), {"siren_loss_grads_absmax_stream": sum(steps)}, "phantom_sanity")
    print(f"[examples] phantom_sanity: {rows}; phase-1 steps {steps}; gates passed; "
          f"{wall:.1f} s")

    _reset_all_counts()
    t0 = time.perf_counter()
    res = sr3d_demo.main(["--epochs", "60"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n1 = 60 - 6
    odd = sum(e % 2 for e in range(n1, 60))
    pn_steps = (6 - odd) * res.timings["num_combinations"]
    chunks = sum(math.ceil(a.size / INFER_CHUNK) for a in (res.recon_2x, res.sr_hr_grid))
    _check_only(_all_counts(), {"siren_loss_grads_wg": n1 + odd, "siren_fused_bwd_wg": pn_steps,
                                "siren_forward_wg": pn_steps + chunks}, "sr3d_demo")
    ssim = np.asarray([r[3:] for r in res.ssim_rows])
    _require(bool(np.isfinite(ssim).all()) and bool(np.isfinite(res.losses).all()),
             "sr3d_demo: non-finite losses or SSIM")
    print(f"[examples] sr3d_demo --epochs 60: {len(res.ssim_rows)} SSIM rows, SR above the "
          f"spline in {int((ssim[:, 1] > ssim[:, 0]).sum())}; loss {res.losses[0]:.4e} -> "
          f"{res.losses[-1]:.4e}; {wall:.1f} s")

    _reset_all_counts()
    t0 = time.perf_counter()
    fits = wire_vs_siren.main(["--steps", "100"])
    wall = time.perf_counter() - t0
    _check_only(_all_counts(), {}, "wire_vs_siren")
    _require(all(np.isfinite(v).all() for v in fits.values()),
             f"wire_vs_siren: non-finite results {fits}")
    print(f"[examples] wire_vs_siren --steps 100: (final loss, PSNR dB) {fits}; {wall:.1f} s")


def _train_dp_args(out_dir: str, tag: str) -> list:
    return ["--conv_kernel", "--batch_size", str(TRAIN_BATCH), "--hr_size", "96",
            "--epochs", "1", "--evaluate_every", "2", "--ckpt_dir",
            os.path.join(out_dir, f"ckpt_{tag}"), "--log_dir", os.path.join(out_dir, f"logs_{tag}"),
            "--device", "cuda", "--seed", "0"]


def _ensemble_problem(seed: int):
    """The 2-D ensemble's batched fit at full width on the card: three
    seeded Siren(2 -> 64x7 -> 1) stacked, the 60 x 60 ROI grid and its 3x
    grid, targets in Normalize(0.5, 0.5) space and acceptance weights with
    one row in ten rejected for each of the nine acquisitions of each
    direction."""
    import torch

    from mri_super_resolution_tpu_torch.config import Master2DConfig
    from mri_super_resolution_tpu_torch.core.coords import mgrid
    from mri_super_resolution_tpu_torch.models import Siren

    gen = torch.Generator().manual_seed(seed)
    models = [Siren(2, MASTER_HIDDEN, MASTER_LAYERS, generator=gen) for _ in range(MASTER_DIRS)]
    init = [torch.stack(t).cuda() for t in zip(*(m.weights() for m in models))]
    scale = Master2DConfig().scale
    shape = (MASTER_DIRS, MASTER_SLOTS, MASTER_P, 1)
    pixels = (torch.rand(shape, generator=gen) * 2 - 1).cuda()
    weights = (torch.rand(shape, generator=gen) > 0.1).float().cuda()
    return (models[0], init, mgrid((60, 60), device="cuda"),
            mgrid((60 * scale, 60 * scale), device="cuda"), pixels, weights)


def _alternating_problem(P: int, dims, seed: int):
    """The 3-D main path's fit at the flagship on the card: the 25 x 25 x 28
    x 4 LR grid (70,000 rows) encoded by B (mapping 128), a seeded SIREN
    256 -> 512x4 -> 1 and PerturbNet of width 128 (the reference preset's),
    a mean target and SHARD_ALT_ACQ acquisitions in [0, 1]."""
    import torch

    from mri_super_resolution_tpu_torch.core.coords import fourier_encode, fourier_matrix, mgrid
    from mri_super_resolution_tpu_torch.models import PerturbNet, Siren

    gen = torch.Generator().manual_seed(seed)
    shape = (25, 25, 28, 4)
    _require(P == 25 * 25 * 28 * 4, "the alternating fit runs at the flagship's 70,000 rows")
    B = fourier_matrix(gen, dims[0] // 2, len(shape), device="cuda")
    ff = fourier_encode(mgrid(shape, device="cuda"), B)
    inr = Siren(dims[0], dims[1], len(dims) - 3, generator=gen, device="cuda")
    inr.requires_grad_(False)
    pn = PerturbNet(ff.shape[1], 128, len(shape), generator=gen, device="cuda")
    pn.requires_grad_(False)
    target = torch.rand(P, 1, generator=gen).cuda()
    acq = torch.rand(SHARD_ALT_ACQ, P, 1, generator=gen).cuda()
    return inr, pn, ff, B, target, acq


def _fit_programs_rank(P: int, dims, erd_target, flat, one) -> dict:
    """``fit_ensemble_batched``, ``fit_alternating_pn`` and ``fit_until``
    with ``mesh=flat`` on this rank's shards, then on rank 0 each on the
    whole batch (a mesh of one); every run's launches counted from 0 and
    its wall-clock taken."""
    import torch
    import torch.distributed as dist

    from mri_super_resolution_tpu_torch.core.coords import mgrid
    from mri_super_resolution_tpu_torch.fit.engine import (fit_alternating_pn,
                                                          fit_ensemble_batched, fit_until,
                                                          plain_apply_init)
    from mri_super_resolution_tpu_torch.fit.optim import Adam, StackedAdam
    from mri_super_resolution_tpu_torch.models import SirenERD, perturbnet_apply
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk
    from mri_super_resolution_tpu_torch.parallel import Spec, shard_batch
    from mri_super_resolution_tpu_torch.pipelines.inr_erd import PRETRAIN_MAX_STEPS

    rank = dist.get_rank()
    out = {}

    def on(mesh, x, spec=None):
        return x if mesh is one else shard_batch(x, mesh, spec)

    def run(tag: str, fn):
        """``fn(mesh)`` on every rank's shards, then on rank 0 alone."""
        for mesh, suffix in ((flat, ""), (one, "_ref")):
            if mesh is one and rank != 0:
                continue
            _reset_all_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(mesh)
            torch.cuda.synchronize()
            out[f"{tag}_s{suffix}"] = time.perf_counter() - t0
            out[f"{tag}_launches{suffix}"] = _all_counts()
            out[f"{tag}{suffix}"] = res
        dist.barrier()

    model, init, coords, coords_s, pixels, weights = _ensemble_problem(seed=91)
    omegas = model.omegas
    vag_w = sk.make_fused_weighted_value_and_grad_batched(model)
    acq_spec = Spec(None, None, "data")

    def ensemble(steps: int, seg: int):
        def fit(mesh):
            res = fit_ensemble_batched(
                lambda p, x: sk.siren_forward_batched_ref(x, p, omegas), StackedAdam(init, 3e-4),
                on(mesh, coords), on(mesh, pixels, acq_spec), on(mesh, weights, acq_spec),
                on(mesh, coords), on(mesh, coords_s), steps, seg,
                weighted_value_and_grad_fn=vag_w, mesh=mesh)
            if steps == SHARD_ENS_SHORT and mesh is flat:
                # the gathered tail of one step: the final params on the whole grids
                with torch.no_grad():
                    whole = [sk.siren_forward_batched_ref(c, res.params, omegas)
                             for c in (coords, coords_s)]
                out["ensemble_short_gather"] = max(
                    float((got - w).abs().max() / w.abs().max())
                    for got, w in zip((res.pred_1x, res.pred_scale), whole))
            return {"losses": res.losses.cpu().numpy(), "pred_1x": res.pred_1x.cpu().numpy(),
                    "pred_scale": res.pred_scale.cpu().numpy(),
                    "rows": int(on(mesh, coords).shape[0])}
        return fit

    run("ensemble", ensemble(SHARD_ENS_STEPS, SHARD_ENS_SEG))
    run("ensemble_short", ensemble(SHARD_ENS_SHORT, 1))

    inr, pn, ff, B, target, acq = _alternating_problem(P, dims, seed=92)

    def alternating(mesh):
        res = fit_alternating_pn(
            lambda p, x: sk.siren_fused(x, p), perturbnet_apply,
            Adam([w.clone() for w in inr.weights()], 1e-4),
            Adam([w.clone() for w in pn.weights()], 1e-6), on(mesh, ff), on(mesh, target),
            on(mesh, acq, Spec(None, "data")), B, num_epochs=SHARD_ALT_EPOCHS,
            pn_epochs=SHARD_ALT_PN, inr_value_and_grad=lambda p, x, t: sk.siren_loss_grads(x, p, t),
            mesh=mesh)
        return {"losses": res.losses.cpu().numpy(), "rows": int(on(mesh, ff).shape[0])}

    run("alternating", alternating)
    del inr, pn, ff, target, acq

    erd_coords, erd_target = mgrid((ERD_SIDE, ERD_SIDE), device="cuda"), erd_target.cuda()

    def until(mesh):
        model = SirenERD(2, ERD_HIDDEN, ERD_LAYERS, perturb=True, device="cuda")
        apply_fn, init_fn = plain_apply_init(model, torch.Generator().manual_seed(0))
        res = fit_until(apply_fn, ERD_LR, init_fn, on(mesh, erd_coords), on(mesh, erd_target),
                        ERD_THRESHOLD, PRETRAIN_MAX_STEPS, sk.make_fused_value_grad_absmax(model),
                        mesh=mesh)
        return {"losses": res.losses, "steps": res.steps, "restarts": res.restarts,
                "loss": res.loss, "rows": int(on(mesh, erd_coords).shape[0])}

    run("until", until)
    return out


def _sharded_rank(P: int, dims, out_dir: str, erd_target) -> dict:
    """One rank of ``phase_sharded`` (two ranks share the card over gloo):
    each program on this rank's shard, the one-rank references on rank 0,
    each program's launches counted from 0."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mri_super_resolution_tpu_torch import set_float32_precision
    from mri_super_resolution_tpu_torch.cli import train_misr
    from mri_super_resolution_tpu_torch.fit.optim import Adam
    from mri_super_resolution_tpu_torch.fit.trainer import Trainer
    from mri_super_resolution_tpu_torch.ops.siren_kernel import make_fused_value_and_grad
    from mri_super_resolution_tpu_torch.parallel import (make_mesh, make_sharded_fit,
                                                         make_tp_fit, make_tp_mesh,
                                                         pad_to_multiple, restore_sharded,
                                                         save_sharded, shard_batch,
                                                         siren_tp_specs)
    from mri_super_resolution_tpu_torch.parallel.distributed import device_mesh, shard_leaf
    from mri_super_resolution_tpu_torch.parallel.tp_fit import shard_params

    set_float32_precision()
    rank = dist.get_rank()
    out = {"rank": rank}
    x, ws, target, _ = _flagship_inputs(P, dims, seed=1)
    module = _siren_module(dims, ws)
    module.requires_grad_(False)
    vag = make_fused_value_and_grad(module)
    flat, one = make_mesh(case=1), make_mesh(1, 1, ranks=[rank])
    adam = lambda p: Adam(p, 1e-4)  # noqa: E731

    def timed(fn, reps=1):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) / reps

    # K1 on each rank's 35,000 rows
    fit2 = make_sharded_fit(None, adam, flat, SHARD_STEPS, value_and_grad_fn=vag)
    xs, ts = shard_batch(x, flat), shard_batch(target, flat)
    _reset_all_counts()
    res = fit2(ws, xs, ts)
    out["k1_launches"] = _all_counts()
    out["k1_rows"] = int(xs.shape[0])
    out["k1_losses"] = res.losses.cpu().numpy()
    _, out["k1_s"] = timed(lambda: fit2(ws, xs, ts), 2)
    # the ragged batch: 69,997 rows padded to 69,998, K1 on each rank's real rows
    xp, n_rows = pad_to_multiple(x[:P - 3], 2)
    tp, _ = pad_to_multiple(target[:P - 3], 2)
    _reset_all_counts()
    res = make_sharded_fit(None, adam, flat, SHARD_STEPS, value_and_grad_fn=vag,
                           n_rows=n_rows)(ws, shard_batch(xp, flat), shard_batch(tp, flat))
    out["ragged_launches"] = _all_counts()
    out["ragged_losses"] = res.losses.cpu().numpy()
    # tensor parallelism: the width over the two ranks, the whole batch on each
    specs = siren_tp_specs(module)
    tp_mesh = make_tp_mesh(data=1, model=2)
    tp2 = make_tp_fit(module, adam, tp_mesh, TP_STEPS, specs)
    _reset_all_counts()
    res_tp, out["tp_s"] = timed(lambda: tp2(ws, x, target))
    out["tp_launches"] = _all_counts()
    out["tp_losses"] = res_tp.losses.cpu().numpy()
    # a sharded checkpoint of the tensor-parallel shards (DTensor leaves)
    dmesh = device_mesh(tp_mesh, "cpu")
    shards = [s.cpu() for s in shard_params(res_tp.params, specs, tp_mesh)]
    tree = {f"w{i}": shard_leaf(s, dmesh, sp) for i, (s, sp) in enumerate(zip(shards, specs))}
    tree["step"] = torch.tensor(TP_STEPS)
    path = os.path.join(out_dir, "sharded_ckpt")
    t0 = time.perf_counter()
    save_sharded(path, tree)
    back = restore_sharded(path, {k: v * 0 for k, v in tree.items()})
    out["ckpt_s"] = time.perf_counter() - t0
    out["ckpt_equal"] = (all(torch.equal(back[k].to_local(), tree[k].to_local())
                             for k in tree if k != "step") and int(back["step"]) == TP_STEPS)
    # the engine's three fits on the data axis
    out.update(_fit_programs_rank(P, dims, erd_target, flat, one))
    # the MISR trainer, batch 32 over the two ranks
    steps, train_step = [], Trainer.train_step

    def rec_step(self, micro):
        before = _all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, psnr = train_step(self, micro)
        torch.cuda.synchronize()
        steps.append((float(loss), {k: v - before[k] for k, v in _all_counts().items()},
                      int(micro[0][3].shape[0]), time.perf_counter() - t0))
        return loss, psnr

    os.environ["MRI_SR_DATA_DIR"] = os.path.join(out_dir, "train_data")
    Trainer.train_step = rec_step
    try:
        _reset_all_counts()
        t0 = time.perf_counter()
        trainer = train_misr.main(_train_dp_args(out_dir, "dp") + ["--data_parallel"])
        torch.cuda.synchronize()
        out["train_s"] = time.perf_counter() - t0
        out["train_launches"] = _all_counts()
        out["train_steps"] = list(steps)
        out["train_val_batches"] = -(-len(train_misr.split_dataset(*train_misr.build_dataset(
            hr_size=96))[1][0]) // TRAIN_BATCH)
        out["train_step"] = trainer.state.step
        dist.barrier()
        if rank == 0:  # the one-rank references
            out["k1_ref_losses"] = make_sharded_fit(None, adam, one, SHARD_STEPS,
                                                    value_and_grad_fn=vag)(
                ws, x, target).losses.cpu().numpy()
            fit1 = make_sharded_fit(None, adam, one, SHARD_STEPS, value_and_grad_fn=vag)
            _, out["k1_ref_s"] = timed_local(lambda: fit1(ws, x, target), 2)
            out["ragged_ref_losses"] = make_sharded_fit(None, adam, one, SHARD_STEPS,
                                                        value_and_grad_fn=vag)(
                ws, x[:P - 3], target[:P - 3]).losses.cpu().numpy()
            tp1 = make_tp_fit(module, adam, make_tp_mesh(1, 1, ranks=[rank]), TP_STEPS, specs)
            res1, out["tp_ref_s"] = timed_local(lambda: tp1(ws, x, target))
            out["tp_ref_losses"] = res1.losses.cpu().numpy()
            del steps[:]
            t0 = time.perf_counter()
            train_misr.main(_train_dp_args(out_dir, "one"))
            torch.cuda.synchronize()
            out["train_ref_s"] = time.perf_counter() - t0
            out["train_ref_steps"] = list(steps)
    finally:
        Trainer.train_step = train_step
    dist.barrier()
    return out


def timed_local(fn, reps: int = 1):
    """(the last result, seconds a call) of ``reps`` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) / reps


def _trace_rel(a, b) -> float:
    import numpy as np

    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))))


def _alternating_counts() -> tuple[int, int]:
    """(K1 launches, K3 and K2 launches each) of the alternating fit's
    schedule: the mean steps and odd alternating epochs run K1, the even
    ones a PerturbNet step per acquisition."""
    n1 = SHARD_ALT_EPOCHS - SHARD_ALT_PN
    odd = sum(e % 2 for e in range(n1, SHARD_ALT_EPOCHS))
    return n1 + odd, (SHARD_ALT_PN - odd) * SHARD_ALT_ACQ


def _first_over(a, b, tol: float):
    """The first index at which ``a`` departs from ``b`` by more than
    ``tol`` relative, or None."""
    import numpy as np

    over = np.flatnonzero(np.abs(np.asarray(a) / np.asarray(b) - 1.0).reshape(len(a), -1)
                          .max(axis=1) > tol)
    return int(over[0]) if len(over) else None


def _check_fit_programs(ranks: list, P: int) -> dict:
    """The engine's three fits on the data axis: each rank's launches, the
    ranks bit-equal, each trace against one rank's in its window (see
    SHARD_ENS_WINDOW); prints both stop steps of phase 1 and where each
    trace leaves SHARD_RTOL. Returns each program's launches summed over the
    ranks, by kernel-row name."""
    import numpy as np

    r0 = ranks[0]
    n_k1, n_pn = _alternating_counts()
    until_key = "siren_loss_grads_absmax_stream"
    ens_key = "siren_loss_grads_weighted_resident_tc_batched"
    want = {"ensemble": {ens_key: SHARD_ENS_STEPS * MASTER_SLOTS},
            "ensemble_short": {ens_key: SHARD_ENS_SHORT * MASTER_SLOTS},
            "alternating": {"siren_loss_grads_wg": n_k1, "siren_forward_wg": n_pn,
                            "siren_fused_bwd_wg": n_pn}}
    rows = {"ensemble": MASTER_P // 2, "ensemble_short": MASTER_P // 2,
            "alternating": P // 2, "until": ERD_SIDE ** 2 // 2}
    for r in ranks:
        for tag in rows:
            w = want.get(tag, {until_key: r["until"]["steps"]})
            _check_only(r[f"{tag}_launches"], w, f"sharded {tag} (rank {r['rank']})")
            _require(r[tag]["rows"] == rows[tag], f"rank {r['rank']}: {tag} on "
                     f"{r[tag]['rows']} rows")
            got, ref = r[tag], r0[tag]
            for k in ("losses", "pred_1x", "pred_scale", "steps", "restarts"):
                if k in got:
                    _require(np.array_equal(np.asarray(got[k]), np.asarray(ref[k])),
                             f"sharded {tag}: the ranks' {k} differ")
    for tag in rows:
        w = want.get(tag, {until_key: r0["until_ref"]["steps"]})
        _check_only(r0[f"{tag}_launches_ref"], w, f"one-rank {tag}")
    for tag in ("ensemble", "ensemble_short"):
        _require(all(r0[tag][k].shape == r0[f"{tag}_ref"][k].shape
                     and bool(np.isfinite(r0[tag][k]).all()) for k in ("pred_1x", "pred_scale")),
                 "the gathered ensemble predictions do not have the one-rank shapes")
    ens, ens1 = r0["ensemble"]["losses"], r0["ensemble_ref"]["losses"]
    short, short1 = r0["ensemble_short"], r0["ensemble_short_ref"]
    alt, alt1 = r0["alternating"]["losses"], r0["alternating_ref"]["losses"]
    u, u1 = r0["until"], r0["until_ref"]
    n = min(len(u["losses"]), len(u1["losses"]))
    rel = {"ensemble": _trace_rel(ens[:SHARD_ENS_WINDOW], ens1[:SHARD_ENS_WINDOW]),
           "ensemble_short": _trace_rel(short["losses"], short1["losses"]),
           "ensemble_short gathered predictions": max(r["ensemble_short_gather"] for r in ranks),
           "alternating": _trace_rel(alt, alt1),
           "until": _trace_rel(u["losses"][:K1_TRACE_STEPS], u1["losses"][:K1_TRACE_STEPS])}
    print(f"[sharded] fit_ensemble_batched: {MASTER_DIRS} directions x {MASTER_SLOTS} "
          f"acquisitions, {MASTER_P // 2} rows a rank, {SHARD_ENS_STEPS} steps ({ens_key} "
          f"{SHARD_ENS_STEPS * MASTER_SLOTS} a rank): losses vs one rank worst rel "
          f"{rel['ensemble']:.2e} over the first {SHARD_ENS_WINDOW} steps, "
          f"{_trace_rel(ens, ens1):.2e} over all {SHARD_ENS_STEPS} (first step beyond "
          f"{SHARD_RTOL:g}: {_first_over(ens, ens1, SHARD_RTOL)}); {SHARD_ENS_SHORT} steps: "
          f"losses worst rel {rel['ensemble_short']:.2e}, gathered predictions vs the final "
          f"params on the whole grids worst gap / max "
          f"{rel['ensemble_short gathered predictions']:.2e}, vs one rank's "
          f"{max(float(np.abs(short[k] - short1[k]).max() / np.abs(short1[k]).max()) for k in ('pred_1x', 'pred_scale')):.2e}; "
          f"{r0['ensemble_s']:.3f} s on two ranks vs "
          f"{r0['ensemble_s_ref']:.3f} s on one")
    print(f"[sharded] fit_alternating_pn: flagship on {P // 2} rows a rank, "
          f"{SHARD_ALT_EPOCHS} epochs ({SHARD_ALT_PN} alternating, {SHARD_ALT_ACQ} "
          f"acquisitions; K1 {n_k1}, K3 and K2 {n_pn} each a rank): losses {alt.tolist()} vs "
          f"one rank worst rel {rel['alternating']:.2e}; {r0['alternating_s']:.3f} s on two "
          f"ranks vs {r0['alternating_s_ref']:.3f} s on one")
    print(f"[sharded] fit_until (soft-ERD phase 1 to {ERD_THRESHOLD:g}): {ERD_SIDE ** 2 // 2} "
          f"rows a rank, stop step {u['steps']} (restarts {u['restarts']}) on two ranks vs "
          f"{u1['steps']} (restarts {u1['restarts']}) on one; worst rel {rel['until']:.2e} "
          f"over the first {K1_TRACE_STEPS} steps, {_trace_rel(u['losses'][:n], u1['losses'][:n]):.2e} "
          f"over the common {n} (first step beyond {SHARD_RTOL:g}: "
          f"{_first_over(u['losses'][:n], u1['losses'][:n], SHARD_RTOL)}); "
          f"{r0['until_s']:.3f} s on two ranks vs {r0['until_s_ref']:.3f} s on one (bars: "
          f"{SHARD_RTOL:g}, stop within {SHARD_STOP_FRAC:.0%})")
    for tag, v in rel.items():
        _require(v <= SHARD_RTOL, f"sharded {tag} vs one rank: {v:.3e}")
    _require(abs(u["steps"] - u1["steps"]) <= SHARD_STOP_FRAC * u1["steps"]
             and u["loss"] <= ERD_THRESHOLD,
             f"sharded phase 1 stops at {u['steps']}, one rank at {u1['steps']}")
    total = lambda tag, key: sum(r[f"{tag}_launches"][key] for r in ranks)  # noqa: E731
    return {f"{ens_key}_shard": total("ensemble", ens_key),
            "siren_forward_wg_shard": total("alternating", "siren_forward_wg"),
            "siren_fused_bwd_wg_shard": total("alternating", "siren_fused_bwd_wg"),
            f"{until_key}_shard": total("until", until_key)}


def phase_sharded(P: int, dims, out_dir: str, erd_target) -> dict:
    """The parallel layer at full width on two gloo ranks sharing the card
    (``parallel/distributed.py:spawn_ranks``): the flagship SIREN's
    data-parallel fit on K1 (35,000 rows a rank, 5 steps), the ragged fit
    (69,997 rows padded to 69,998, K1 on each rank's real rows), the
    tensor-parallel fit (3 steps, width 512 over the two), a sharded
    checkpoint round trip, the engine's three fits with ``mesh=`` (the 2-D
    ensemble on the batched K1-w, the 3-D main path's schedule on K1, K3
    and K2, soft-ERD phase 1 on K1-a to ``erd_target``, the soft-ERD case's
    16,384-row target), and ``train_misr --data_parallel --conv_kernel``
    at full-width RAMS (batch 32, 16 a rank, 2 steps); each against one
    rank, each rank's launches asserted. Returns the K1 launches of the
    data-parallel fit and those of the three fits, summed over the
    ranks."""
    import numpy as np

    from mri_super_resolution_tpu_torch.parallel.distributed import spawn_ranks

    _write_b0_volumes(os.path.join(out_dir, "train_data"))
    t0 = time.perf_counter()
    ranks = spawn_ranks(_sharded_rank, 2, P, dims, out_dir, erd_target.cpu(), device="cuda",
                        timeout=900)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks:
        _check_only(r["k1_launches"], {"siren_loss_grads_wg": SHARD_STEPS},
                    f"sharded K1 (rank {r['rank']})")
        _require(r["k1_rows"] == P // 2, f"rank {r['rank']}: {r['k1_rows']} rows")
        _check_only(r["ragged_launches"], {"siren_loss_grads_wg": SHARD_STEPS},
                    f"ragged K1 (rank {r['rank']})")
        _check_only(r["tp_launches"], {}, f"tensor-parallel (rank {r['rank']})")
        _require(r["ckpt_equal"], f"rank {r['rank']}: the sharded checkpoint differs")
        _require(r["train_step"] == 2 and len(r["train_steps"]) == 2,
                 f"rank {r['rank']}: {r['train_step']} trainer steps")
        for i, (_, d, rows, _) in enumerate(r["train_steps"]):
            _require(rows <= TRAIN_BATCH // 2, f"rank {r['rank']} step {i + 1}: {rows} rows")
            _check_only(d, {"conv3d_rfab": K6_PER_FORWARD, "conv3d_rfab_wg": K6_PER_FORWARD,
                            "conv3d_rfab_bwd": K6_PER_FORWARD},
                        f"trainer step {i + 1} (rank {r['rank']})")
        _check_only(r["train_launches"], {
            "conv3d_rfab": K6_PER_FORWARD * (2 + 2 * r["train_val_batches"]),
            "conv3d_rfab_wg": K6_PER_FORWARD * (2 + 2 * r["train_val_batches"]),
            "conv3d_rfab_bwd": K6_PER_FORWARD * 2}, f"trainer (rank {r['rank']})")
        for key in ("k1_losses", "ragged_losses", "tp_losses"):
            _require(np.array_equal(r[key], r0[key]), f"{key}: the ranks disagree")
    rel_k1 = _trace_rel(r0["k1_losses"], r0["k1_ref_losses"])
    rel_ragged = _trace_rel(r0["ragged_losses"], r0["ragged_ref_losses"])
    rel_tp = _trace_rel(r0["tp_losses"], r0["tp_ref_losses"])
    train = [step[0] for step in r0["train_steps"]]
    train_ref = [step[0] for step in r0["train_ref_steps"]]
    rel_train = _trace_rel(train, train_ref)
    _require(rel_k1 <= SHARD_RTOL, f"sharded K1 fit vs one rank: {rel_k1:.3e}")
    _require(rel_ragged <= SHARD_RTOL, f"ragged fit vs one rank unpadded: {rel_ragged:.3e}")
    _require(rel_tp <= SHARD_RTOL, f"tensor-parallel fit vs one rank: {rel_tp:.3e}")
    _require(rel_train <= TRAIN_DP_RTOL, f"trainer batch-DP vs one rank: {rel_train:.3e}")
    step2, step1 = r0["k1_s"] / SHARD_STEPS, r0["k1_ref_s"] / SHARD_STEPS
    print(f"[sharded] 2 gloo ranks on one card, {wall:.1f} s of phase; K1 data-parallel: "
          f"{SHARD_STEPS} steps on {P // 2} rows a rank, {SHARD_STEPS} tensor-core launches a "
          f"rank, losses {r0['k1_losses'].tolist()} vs one rank on {P} rows worst rel "
          f"{rel_k1:.2e}; ragged {P - 3} rows padded to {P - 2}: worst rel {rel_ragged:.2e}; "
          f"tensor-parallel {TP_STEPS} steps (width 512 over 2): worst rel {rel_tp:.2e}; "
          f"trainer batch {TRAIN_BATCH} over 2 ranks, 2 steps: losses {train} vs one rank "
          f"{train_ref} worst rel {rel_train:.2e} (bar {TRAIN_DP_RTOL:g}); sharded "
          f"checkpoint round trip {r0['ckpt_s']:.2f} s, equal (bars: {SHARD_RTOL:g})")
    print(f"[sharded] times: K1 fit step {step2 * 1e3:.3f} ms on two ranks vs "
          f"{step1 * 1e3:.3f} ms on one ({step2 / step1:.2f}x); tensor-parallel fit "
          f"{r0['tp_s'] / TP_STEPS * 1e3:.3f} ms a step vs {r0['tp_ref_s'] / TP_STEPS * 1e3:.3f}"
          f" ms on one; trainer step 2 (batch {TRAIN_BATCH}, the first after warm-up) "
          f"{r0['train_steps'][1][3] * 1e3:.1f} ms on two ranks vs "
          f"{r0['train_ref_steps'][1][3] * 1e3:.1f} ms on one; train_misr.main() "
          f"{r0['train_s']:.2f} s on two ranks vs {r0['train_ref_s']:.2f} s on one")
    return {"siren_loss_grads_wg_shard": sum(r["k1_launches"]["siren_loss_grads_wg"]
                                             for r in ranks), **_check_fit_programs(ranks, P)}


def phase_k1_shard_time(P: int, dims, errs: dict, launches: dict) -> dict:
    """K1 on its tensor-core route at a shard's P / 2 rows: parity against
    the plain K1 (twice for the same bits), then timed beside the plain K1
    and eager autograd."""
    import torch

    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    n = P // 2
    x, ws, target, _ = _flagship_inputs(P, dims, seed=1)
    x, target = x[:n].contiguous(), target[:n].contiguous()
    loss, grads = sk.siren_loss_grads(x, ws, target)
    loss_b, grads_b = sk.siren_loss_grads(x, ws, target)
    _require(bool(torch.equal(loss, loss_b)) and all(torch.equal(a, b) for a, b in
                                                      zip(grads, grads_b)),
             "K1 (shard): two calls differ")
    ref_loss, ref_grads = sk.siren_loss_grads_ref(x, ws, target)
    worst = _rel(loss, ref_loss)[1]
    err = _rel(loss, ref_loss)[0]
    for g, r in zip(grads, ref_grads):
        worst = max(worst, _rel(g, r)[1])
        err = max(err, _rel(g, r)[0])
    _require(worst <= K1_K2_TOL, f"K1 (shard) rel {worst:.3e}")
    errs["siren_loss_grads_wg_shard"] = err
    print(f"[parity] K1 tensor-core at a shard's P={n}: worst rel {worst:.2e}, two calls "
          f"bit-equal")
    module = _siren_module(dims, ws)
    params = module.weights()

    def lib_loss_grads():
        torch.autograd.grad(torch.mean((module(x) - target) ** 2), params)

    flops, nbytes = _k1_work(n, dims, ws)
    return _time_row("siren_loss_grads_wg_shard", "siren_wg", "siren_kernel.py:518",
                     lambda: sk.siren_loss_grads(x, ws, target),
                     lambda: sk.siren_loss_grads_ref(x, ws, target), lib_loss_grads, flops,
                     nbytes, f"P={n} (a shard of 2)", errs, launches, peak=PEAK_BF16_TC)


def phase_shard_times(P: int, dims, errs: dict, launches: dict) -> list[dict]:
    """The kernels at the shapes of the engine's fits on two ranks, each
    held to its plain version (twice for the same bits) and timed beside
    it, its bound and its library call: the batched K1-w at 1,800 rows a
    rank (57 row tiles, the last of 8 rows), K1-a at 8,192 and K3 and K2
    (dx only, as a PerturbNet step calls it) at 35,000."""
    import torch

    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    rows = []
    # the batched K1-w on a rank's 1,800 rows of the 60 x 60 ROI
    n = MASTER_P // 2
    models, x, targets, sws = zip(*(_master_inputs(seed=101 + d) for d in range(MASTER_DIRS)))
    x, acts = x[0][:n].contiguous(), models[0].acts
    ws = [torch.stack(t) for t in zip(*(m.weights() for m in models))]
    target = torch.stack([t[:n] for t in targets])
    sw = torch.stack([w[:n] for w in sws])
    name = "siren_loss_grads_weighted_resident_tc_batched_shard"
    before = dict(sk.LAUNCHES)
    batched = lambda: sk.siren_loss_grads_batched(x, ws, target, acts=acts, sample_weights=sw)
    got, again = batched(), batched()
    singles = [sk.siren_loss_grads(x, [w[s] for w in ws], target[s], acts=acts,
                                   sample_weights=sw[s]) for s in range(MASTER_DIRS)]
    torch.cuda.synchronize()
    key = "siren_loss_grads_weighted_resident_tc_batched"
    _require(sk.LAUNCHES[key] == before[key] + 2,
             f"the batched K1-w at {n} rows did not take its kernel")
    ref = sk.siren_loss_grads_batched_ref(x, ws, target, 30.0, None, acts, sw)
    errs[name] = _batched_check(f"K1-w batched x{MASTER_DIRS} at a rank's P={n}, "
                                "csrc/siren_resident_tc.cu", got, ref, singles, again)
    kdims = (2,) + (MASTER_HIDDEN,) * (MASTER_LAYERS + 1) + (1,)
    macs = _layer_macs(kdims)
    flops = MASTER_DIRS * 2 * n * (2 * sum(macs) + sum(macs[1:]))
    wbytes = 4 * sum(w.numel() for w in ws)
    nbytes = 4 * x.numel() + 2 * wbytes + 2 * 4 * MASTER_DIRS * n + 4 * MASTER_DIRS
    rows.append(_time_row(
        name, "siren_resident_tc", "siren_kernel.py:518", batched,
        lambda: sk.siren_loss_grads_batched_ref(x, ws, target, 30.0, None, acts, sw),
        _batched_lib(x, ws, target, sw, acts), 3 * flops, nbytes,
        f"P={n}, D={MASTER_DIRS} (a rank's shard)", errs, launches, peak=PEAK_BF16_TC,
        reps=100, rounds=2))

    # K1-a on a rank's 8,192 rows of the 128 x 128 slice
    n = ERD_SIDE ** 2 // 2
    model, x, target = _erd_inputs(seed=103, last_bias=0.05)
    x, target = x[:n].contiguous(), target[:n].contiguous()
    ws, acts = model.weights(), model.acts
    name, key = "siren_loss_grads_absmax_stream_shard", sk.loss_grads_key(False, True, "stream")
    before = dict(sk.LAUNCHES)
    kern = lambda: sk.siren_loss_grads(x, ws, target, acts=acts, with_out_absmax=True)
    (loss, am, grads), again = kern(), kern()
    loss_r, am_r, grads_r = sk.siren_loss_grads_ref(x, ws, target, 30.0, None, acts, None, True)
    torch.cuda.synchronize()
    _require(sk.LAUNCHES == {**before, key: before[key] + 2},
             f"K1-a at {n} rows did not take the streaming route")
    worst = _worst_rel([(loss, loss_r), *zip(grads, grads_r)])
    loss_rel, am_rel = _rel(loss, loss_r)[1], _rel(am, am_r)[1]
    print(f"[parity] K1 absmax/ReLU at a rank's P={n}, streaming route: loss rel {loss_rel:.2e} "
          f"(tol {K1A_LOSS_RTOL:g}); max |out| rel {am_rel:.2e} (tol {K1_ABSMAX_TOL:g}); worst "
          f"over loss/dW max abs {worst[0]:.3e}, rel {worst[1]:.3e} (tol rel {K1_K2_TOL:g})")
    _require(all(torch.equal(a, b) for a, b in zip([loss, am, *grads],
                                                    [again[0], again[1], *again[2]])),
             f"two streaming K1-a calls at {n} rows differ")
    _require(worst[1] <= K1_K2_TOL and am_rel <= K1_ABSMAX_TOL and loss_rel <= K1A_LOSS_RTOL,
             f"K1-a at {n} rows disagrees with its plain version")
    errs[name] = max(worst[0], float((am - am_r).abs()))
    edims = (2,) + (ERD_HIDDEN,) * (ERD_LAYERS + 2) + (1,)
    macs = _layer_macs(edims)
    lib_params = [w.clone().requires_grad_() for w in ws]

    def lib_absmax():
        out = sk.siren_forward_ref(x, lib_params, 30.0, acts)
        torch.autograd.grad(torch.mean((out - target) ** 2), lib_params)
        out.detach().abs().max()

    rows.append(_time_row(
        name, "siren_stream", "siren_kernel.py:518", kern,
        lambda: sk.siren_loss_grads_ref(x, ws, target, 30.0, None, acts, None, True), lib_absmax,
        3 * 2 * n * (2 * sum(macs) + sum(macs[1:])),
        4 * x.numel() + 8 * sum(w.numel() for w in ws) + 4 * n + 8,
        f"P={n} (a rank's shard)", errs, launches, peak=PEAK_BF16_TC, reps=50, rounds=2))

    # K3 and K2 (dx only) on a rank's 35,000 rows of the flagship
    n = P // 2
    x, ws, _, g = _flagship_inputs(P, dims, seed=104)
    x, g = x[:n].contiguous(), g[:n].contiguous()
    before = dict(sk.LAUNCHES)
    out, out2 = sk.siren_forward(x, ws), sk.siren_forward(x, ws)
    dx, _ = sk.siren_fused_bwd(x, ws, g, need_dw=False)
    dx2, _ = sk.siren_fused_bwd(x, ws, g, need_dw=False)
    ref = sk.siren_forward_ref(x, ws)
    dx_r, _ = sk.siren_fused_bwd_ref(x, ws, g, need_dw=False)
    torch.cuda.synchronize()
    _require(sk.LAUNCHES == {**before, "siren_forward_wg": before["siren_forward_wg"] + 2,
                             "siren_fused_bwd_wg": before["siren_fused_bwd_wg"] + 2},
             f"K3 and K2 at {n} rows did not take the tensor-core route")
    (e3, r3), (e2, r2) = _rel(out, ref), _rel(dx, dx_r)
    print(f"[parity] K3 at a rank's P={n}: max abs {e3:.3e}, rel {r3:.3e} (tol {K3_TOL:g}); "
          f"K2 dx only: max abs {e2:.3e}, rel {r2:.3e} (tol {K1_K2_TOL:g}); two calls of each "
          f"bit-equal")
    _require(torch.equal(out, out2) and torch.equal(dx, dx2),
             f"two K3 or K2 calls at {n} rows differ")
    _require(r3 <= K3_TOL and r2 <= K1_K2_TOL, f"K3 or K2 at {n} rows disagrees")
    errs["siren_forward_wg_shard"], errs["siren_fused_bwd_wg_shard"] = e3, e2
    module = _siren_module(dims, ws)
    module.requires_grad_(False)
    xr = x.clone().requires_grad_()

    def lib_forward():
        with torch.no_grad():
            module(x)

    def lib_fused_bwd():
        torch.autograd.grad(module(xr), xr, g)

    macs = _layer_macs(dims)
    fwd, chain = sum(macs), sum(macs[1:])
    bwd = sum(macs[:-1]) + chain + macs[0]
    weight_bytes, in_bytes = 4 * sum(w.numel() for w in ws), 4 * x.numel()
    rows.append(_time_row(
        "siren_forward_wg_shard", "siren_wg", "siren_kernel.py:240",
        lambda: sk.siren_forward(x, ws), lambda: sk.siren_forward_ref(x, ws), lib_forward,
        3 * 2 * n * fwd, in_bytes + weight_bytes + 4 * n, f"P={n} (a rank's shard)", errs,
        launches, peak=PEAK_BF16_TC))
    rows.append(_time_row(
        "siren_fused_bwd_wg_shard", "siren_wg", "siren_kernel.py:377",
        lambda: sk.siren_fused_bwd(x, ws, g, need_dw=False),
        lambda: sk.siren_fused_bwd_ref(x, ws, g, need_dw=False), lib_fused_bwd,
        3 * 2 * n * bwd, 2 * in_bytes + weight_bytes + 4 * n, f"P={n} (a rank's shard)", errs,
        launches, peak=PEAK_BF16_TC))
    return rows


def _best_alternating(kern, lib, reps: int, rounds: int) -> tuple[float, float]:
    """Best of ``rounds`` timings of the kernel and the library call, taken
    in turns (kernel, library, kernel, library, ...)."""
    ms = lib_ms = float("inf")
    for _ in range(rounds):
        ms = min(ms, _time_ms(kern, reps))
        lib_ms = min(lib_ms, _time_ms(lib, reps))
    return ms, lib_ms


def _time_row(name, source, replaces, kern, plain, lib, flops, nbytes, at, errs,
              launches, peak=PEAK_F32_FLOPS, reps=10, rounds=1) -> dict:
    """One entry of the kernels line: the kernel, its plain version and the
    library call timed with CUDA events, beside the bound of the work at
    ``peak`` operations per second; the kernel and the library call in
    ``rounds`` turns, best of each."""
    ms, lib_ms = _best_alternating(kern, lib, reps, rounds)
    plain_ms = _time_ms(plain, reps)
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    print(f"[times] {name} {at}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"library {lib_ms:.3f} ms, bound {max(t_ops, t_bytes):.3f} ms "
          f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB) -> "
          f"{flops / ms / 1e9:.2f} TFLOP/s; kernel/library {ms / lib_ms:.3f}, "
          f"kernel/bound {ms / max(t_ops, t_bytes):.2f}")
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
    """K4 (its tensor-core route, the SIMT K4 in turns, and by pass) at the
    main path's P rows and K5 at its 262,144-row inference chunk (4 ->
    256x2 -> 1), beside eager autograd of the Wire module; K4 at 512x2 and
    K5 at P rows printed for the record."""
    import torch

    from mri_super_resolution_tpu_torch.ops import _build
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

        flops = 2 * P * (fwd + dw + dh)
        tc = lambda: wk.wire_loss_grads(x, ws, oms, target)
        # the tensor-core route's bound: its bf16x3 products at the bf16 peak
        row = _time_row(
            "wire_loss_grads_tc", "wire_tc", "wire_kernel.py:302", tc,
            lambda: wk.wire_loss_grads_ref(x, ws, oms, target), lib_loss_grads,
            3 * flops, 4 * x.numel() + 4 * P + 2 * wbytes + 4, f"P={P}", errs, launches,
            peak=PEAK_BF16_TC)
        stream = _build.stream_ptr()
        tc_ms, simt_ms = _best_alternating(
            tc, lambda: wk._launch_loss_grads(wk._lib(), x, ws, oms, target, P, stream), 5, 2)
        print(f"[times] K4 at P={P} H={H}, routes in turns (best of 2): tensor-core "
              f"{tc_ms:.3f} ms ({flops / tc_ms / 1e9:.1f} float32-equivalent TFLOP/s, "
              f"{3 * flops / tc_ms / 1e9:.1f} TFLOP/s of bf16 products; bound "
              f"{3 * flops / PEAK_BF16_TC * 1e3:.3f} ms), SIMT {simt_ms:.3f} ms "
              f"({flops / simt_ms / 1e9:.1f} TFLOP/s; its f32 bound "
              f"{flops / PEAK_F32_FLOPS * 1e3:.3f} ms)")
        if record:
            _passes("K4 (tensor-core route)", tc)
        gen = torch.Generator().manual_seed(H + 2)
        xc = (torch.rand(INFER_CHUNK, 4, generator=gen) * 2.0 - 1.0).cuda()
        for n, xn in ((P, x), (INFER_CHUNK, xc)):
            @torch.no_grad()
            def plain_forward(xn=xn):
                wk.wire_forward_ref(xn, ws, oms)

            @torch.no_grad()
            def lib_forward(xn=xn):
                model(xn)

            # the tensor-core route's bound: its bf16x3 products at the bf16 peak
            tc5 = lambda xn=xn: wk.wire_forward(xn, ws, oms)
            frow = _time_row(
                "wire_forward_tc", "wire_tc", "wire_kernel.py:146", tc5, plain_forward,
                lib_forward, 3 * 2 * n * fwd, 4 * xn.numel() + wbytes + 4 * n, f"P={n}", errs,
                launches, peak=PEAK_BF16_TC, reps=5)
            tc_ms, simt_ms = _best_alternating(
                tc5, lambda xn=xn: wk._launch_forward(wk._lib(), xn, ws, oms, stream), 5, 2)
            print(f"[times] K5 at P={n} H={H}, routes in turns (best of 2): tensor-core "
                  f"{tc_ms:.3f} ms ({6 * n * fwd / tc_ms / 1e9:.1f} TFLOP/s of bf16 products; "
                  f"bound {6 * n * fwd / PEAK_BF16_TC * 1e3:.3f} ms), SIMT {simt_ms:.3f} ms "
                  f"(its f32 bound {2 * n * fwd / PEAK_F32_FLOPS * 1e3:.3f} ms)")
            if record and n == INFER_CHUNK:
                _passes("K5 at the inference chunk (tensor-core route)", tc5)
        if record:
            rows += [row, frow]  # K5 at the inference chunk, as the path runs it
        print(f"[times] the rows above: width {H}x2")
        del model, x, target, ws, xc
        torch.cuda.empty_cache()
    return rows


def _siren_module(dims, ws):
    """The plain ``Siren`` module on the card holding the weights ``ws``."""
    import torch

    from mri_super_resolution_tpu_torch.models import Siren

    module = Siren(dims[0], dims[1], len(dims) - 3, device="cuda")
    with torch.no_grad():
        for p, w in zip(module.weights(), ws):
            p.copy_(w)
    return module


def _k1_work(P: int, dims, ws) -> tuple[int, int]:
    """K1's tensor-core route at P rows: its bf16x3 products (three bf16
    products for each float32 one: forward, weight gradients, the delta
    chain) and its compulsory bytes (x, the weights and their gradients,
    the target, the loss)."""
    macs = _layer_macs(dims)
    fwd, chain = sum(macs), sum(macs[1:])
    weight_bytes = 4 * sum(w.numel() for w in ws)
    return 3 * 2 * P * (2 * fwd + chain), 4 * P * dims[0] + 2 * weight_bytes + 4 * P + 4


def phase_k1_hybrid_time(P: int, dims, errs: dict, launches: dict) -> dict:
    """K1 on its tensor-core route at the hybrid fit's P rows, beside the
    plain K1 and eager autograd of the Siren module."""
    import torch

    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    x, ws, target, _ = _flagship_inputs(P, dims, seed=5)
    module = _siren_module(dims, ws)
    params = module.weights()

    def lib_loss_grads():
        loss = torch.mean((module(x) - target) ** 2)
        torch.autograd.grad(loss, params)

    flops, nbytes = _k1_work(P, dims, ws)
    return _time_row("siren_loss_grads_wg_hybrid", "siren_wg", "siren_kernel.py:518",
                     lambda: sk.siren_loss_grads(x, ws, target),
                     lambda: sk.siren_loss_grads_ref(x, ws, target), lib_loss_grads, flops,
                     nbytes, f"P={P} (hybrid)", errs, launches, peak=PEAK_BF16_TC)


def _batched_lib(x, ws, target, sw=None, acts=None):
    """The library yardstick of a batched K1: eager autograd of the D
    slots' (weighted) MSEs through the plain batched forward (``einsum``
    and ``torch.bmm`` over the stacked weights)."""
    import torch

    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    leaves = [w.clone().requires_grad_() for w in ws]

    def lib():
        sq = (sk.siren_forward_batched_ref(x, leaves, 30.0, acts) - target) ** 2
        loss = (sq if sw is None else sw * sq).mean(dim=(1, 2))
        torch.autograd.grad(loss.sum(), leaves)

    return lib


def _wg_passes(P: int, dims, D: int) -> dict:
    """csrc/siren_wg.cu's passes at D slots of P rows with the bf16 stash:
    for each kernel (``wg_kernel<0, 0>`` FWD, ``<1, 0>`` the last hidden
    FWD, ``<2, 0>`` CHAIN, ``<3, 0>`` DW, the last layer, the split and the
    sums) its launches, its
    tensor-core products (bf16x3 for FWD and CHAIN, two a k step for DW's
    bf16 stash) and the bytes its design moves: each operand plane read
    once, each output plane written once (activations hi/lo, the last
    hidden's hi, F in bf16, deltas hi/lo, dW's float32 partials)."""
    L = len(dims) - 1
    out = {}

    def add(name, flops, nbytes):
        n, f, b = out.get(name, (0, 0, 0))
        out[name] = (n + 1, f + flops, b + nbytes)

    for l in range(L - 1):
        din, dout = dims[l], dims[l + 1]
        a_in = 4 * P * din * (1 if l == 0 else D)  # x's planes are shared
        if l + 2 < L:
            add("wg_kernel<0, 0>", 6 * D * P * din * dout, a_in + 6 * D * P * dout)
        else:
            add("wg_kernel<1, 0>", 6 * D * P * din * dout, a_in + 4 * D * P * dout
                + 4 * D * P * dout // 128)
        add("wg_kernel<3, 0>", 4 * D * P * din * dout,
            4 * D * P * dout + 2 * P * din * (1 if l == 0 else D) + 4 * D * dout * din)
        if l > 0:
            add("wg_kernel<2, 0>", 6 * D * P * din * dout, 4 * D * P * dout + 2 * D * P * din
                + 4 * D * P * din)
    W = dims[L - 1]
    add("last_layer_kernel<0>", 0, 4 * D * P * W + 4 * D * P * W + 4 * D * P * (W // 128 + 1))
    return out


def _k1_wg_work(P: int, dims, D: int) -> tuple[int, int]:
    """The batched K1's work on csrc/siren_wg.cu at D slots: its tensor-core
    products (bf16x3 forward and chain, two products for dW with the bf16
    stash) and its compulsory bytes (x once, each slot's weights, their
    gradients, targets and losses)."""
    macs = _layer_macs(dims)
    fwd, chain = sum(macs), sum(macs[1:])
    weight_bytes = 4 * sum(dims[l + 1] * (dims[l] + 1) for l in range(len(dims) - 1))
    return (2 * D * P * (3 * fwd + 3 * chain + 2 * fwd),
            4 * P * dims[0] + D * (2 * weight_bytes + 4 * P + 4))


def phase_k1_batched_time(P: int, dims, errs: dict, launches: dict) -> dict:
    """The batched K1 of the tensor-core class (csrc/siren_wg.cu) at the
    hybrid fit's shape (D = 4 on P = 100,800 rows) beside its plain batched
    version with the bf16 stash and eager autograd over ``torch.bmm``; then
    the batched call and four unbatched tensor-core K1 calls in turns, and
    the batched call by pass beside each pass's product bound and bytes."""
    import torch

    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    x, ws, target = _stacked_inputs(P, dims, HYBRID_TES, seed=62)
    flops, nbytes = _k1_wg_work(P, dims, HYBRID_TES)
    batched = lambda: sk.siren_loss_grads_batched(x, ws, target)
    singles = [([w[s].contiguous() for w in ws], target[s].contiguous())
               for s in range(HYBRID_TES)]

    def in_turn():
        for w1, t1 in singles:
            sk.siren_loss_grads(x, w1, t1)

    row = _time_row("siren_loss_grads_wg_batched", "siren_wg", "siren_kernel.py:518", batched,
                    lambda: sk.siren_loss_grads_batched_ref(x, ws, target, stash="bf16"),
                    _batched_lib(x, ws, target), flops, nbytes,
                    f"P={P}, D={HYBRID_TES} (hybrid)", errs, launches, peak=PEAK_BF16_TC,
                    reps=5)
    b_ms, t_ms = _best_alternating(batched, in_turn, 5, 2)
    print(f"[times] K1 at the hybrid's P={P}, batched over {HYBRID_TES} TEs vs {HYBRID_TES} "
          f"unbatched calls in turn (CUDA events, best of 2): batched {b_ms:.3f} ms, in turn "
          f"{t_ms:.3f} ms ({t_ms / HYBRID_TES:.3f} ms a call); batched / in turn "
          f"{b_ms / t_ms:.3f}")
    del x, ws, target, singles
    torch.cuda.empty_cache()
    per = _fresh_passes(P, dims, HYBRID_TES)
    for name, (n, f, b) in _wg_passes(P, dims, HYBRID_TES).items():
        ms = per.get(name)
        t_ops, t_bytes = f / PEAK_BF16_TC * 1e3, b / PEAK_BYTES * 1e3
        print(f"[passes] K1 batched x{HYBRID_TES} {name} ({n} launches): "
              + ("not measured" if ms is None else f"{ms:.3f} ms a call")
              + f"; product bound {t_ops:.3f} ms ({f / 1e12:.3f} TFLOP), bytes {b / 1e9:.3f} GB "
              f"({t_bytes:.3f} ms at 3.35 TB/s)"
              + ("" if ms is None else f"; ms / larger bound {ms / max(t_ops, t_bytes):.2f}"))
    return row


FRESH_PASSES = """
import json, sys
import chip_smoke as cs
from mri_super_resolution_tpu_torch import set_float32_precision
from mri_super_resolution_tpu_torch.ops import siren_kernel as sk
set_float32_precision()
P, dims, D = int(sys.argv[1]), tuple(json.loads(sys.argv[2])), int(sys.argv[3])
x, ws, target = cs._stacked_inputs(P, dims, D, seed=62)
per = cs._passes(f"K1 batched x{D} (csrc/siren_wg.cu, a fresh process)",
                 lambda: sk.siren_loss_grads_batched(x, ws, target), calls=2)
print(json.dumps(per))
"""


FRESH_K1W_PASSES = """
import json
import torch
import chip_smoke as cs
from mri_super_resolution_tpu_torch import set_float32_precision
from mri_super_resolution_tpu_torch.ops import siren_kernel as sk
set_float32_precision()
models, x, targets, sws = zip(*(cs._master_inputs(seed=81 + d) for d in range(cs.MASTER_DIRS)))
ws = [torch.stack(t) for t in zip(*(m.weights() for m in models))]
target, sw = torch.stack(targets), torch.stack(sws)
per = cs._passes(f"K1-w batched x{cs.MASTER_DIRS} (csrc/siren_resident_tc.cu, a fresh process)",
                 lambda: sk.siren_loss_grads_batched(x[0], ws, target, acts=models[0].acts,
                                                     sample_weights=sw), calls=20)
print(json.dumps(per))
"""


def _fresh_passes(P: int, dims, D: int, code: str = FRESH_PASSES) -> dict:
    """A batched K1's passes under ``torch.profiler`` in a process of its
    own (``code``: the hybrid's batched K1, or with FRESH_K1W_PASSES the
    2-D ensemble's): late in this script the profiler drops device events
    (K1's passes sum to less than its call, K5's to none), which a fresh
    process does not. Returns the ms a call by kernel name."""
    import subprocess

    p = subprocess.run([sys.executable, "-c", code, str(P), json.dumps(list(dims)),
                        str(D)], cwd=os.path.dirname(os.path.abspath(__file__)),
                       capture_output=True, text=True, timeout=600, stdin=subprocess.DEVNULL)
    lines = p.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line)
    _require(p.returncode == 0 and lines, f"the fresh per-pass profile failed: {p.stderr[-2000:]}")
    return json.loads(lines[-1])


def phase_k1w_batched_time(errs: dict, launches: dict) -> dict:
    """The batched K1-w (``csrc/siren_resident_tc.cu``) at the 2-D
    ensemble's shape (D = 3 on P = 3,600 rows) beside its tensor-core bound
    (the bf16x3 products at the bf16 peak), its plain batched version and
    eager autograd over ``torch.bmm``; by kernel under ``torch.profiler``;
    the batched call and three unbatched (streaming) calls in turns; and on
    the host clock the 2-D update's costs per batched update: the call, the
    stacked Adam step over the three directions' (3, 25,217) buffer, and
    both, beside three unbatched updates with three Adams."""
    import torch

    from mri_super_resolution_tpu_torch.fit.optim import Adam, StackedAdam
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    models, x, targets, sws = zip(*(_master_inputs(seed=81 + d) for d in range(MASTER_DIRS)))
    x, acts = x[0], models[0].acts
    ws = [torch.stack(t) for t in zip(*(m.weights() for m in models))]
    target, sw = torch.stack(targets), torch.stack(sws)
    dims = (2,) + (MASTER_HIDDEN,) * (MASTER_LAYERS + 1) + (1,)
    macs = _layer_macs(dims)
    wbytes = 4 * sum(w.numel() for w in ws)
    flops = MASTER_DIRS * 2 * MASTER_P * (2 * sum(macs) + sum(macs[1:]))
    batched = lambda: sk.siren_loss_grads_batched(x, ws, target, acts=acts, sample_weights=sw)
    singles = [([w[s].contiguous() for w in ws], target[s].contiguous(), sw[s].contiguous())
               for s in range(MASTER_DIRS)]

    def in_turn():
        for w1, t1, s1 in singles:
            sk.siren_loss_grads(x, w1, t1, acts=acts, sample_weights=s1)

    nbytes = 4 * x.numel() + 2 * wbytes + 2 * 4 * MASTER_DIRS * MASTER_P + 4 * MASTER_DIRS
    row = _time_row(
        "siren_loss_grads_weighted_resident_tc_batched", "siren_resident_tc",
        "siren_kernel.py:518",
        batched, lambda: sk.siren_loss_grads_batched_ref(x, ws, target, 30.0, None, acts, sw),
        _batched_lib(x, ws, target, sw, acts), 3 * flops, nbytes,
        f"P={MASTER_P}, D={MASTER_DIRS}", errs, launches, peak=PEAK_BF16_TC, reps=100, rounds=2)
    b_ms, t_ms = _best_alternating(batched, in_turn, 100, 2)
    print(f"[times] K1-weighted at P={MASTER_P}, batched over {MASTER_DIRS} directions vs "
          f"{MASTER_DIRS} unbatched calls in turn (CUDA events, 100 calls, best of 2): batched "
          f"{b_ms:.4f} ms, in turn {t_ms:.4f} ms; bf16x3 tensor-core bound "
          f"{3 * flops / PEAK_BF16_TC * 1e3:.4f} ms")
    per = _fresh_passes(MASTER_P, dims, MASTER_DIRS, FRESH_K1W_PASSES)
    t_ops, t_bytes = row["bound_ms"], nbytes / PEAK_BYTES * 1e3
    for name, ms in per.items():
        print(f"[passes] K1-w batched x{MASTER_DIRS} {name} (1 launch a call, the whole call): "
              f"{ms:.4f} ms a call; product bound {3 * flops / PEAK_BF16_TC * 1e3:.4f} ms "
              f"({3 * flops / 1e12:.4f} TFLOP of bf16x3 products), bytes {nbytes / 1e6:.3f} MB "
              f"({t_bytes:.4f} ms at 3.35 TB/s); ms / bound {ms / t_ops:.2f}")
    opt = StackedAdam(ws, 3e-4)
    grads = batched()[1]
    opts = [Adam([w.clone() for w in w1], 3e-4) for w1, _, _ in singles]
    grads1 = [sk.siren_loss_grads(x, w1, t1, acts=acts, sample_weights=s1)[1]
              for w1, t1, s1 in singles]

    def update():
        opt.step(sk.siren_loss_grads_batched(x, opt.params, target, acts=acts,
                                             sample_weights=sw)[1])

    def updates_in_turn():
        for o, (_, t1, s1) in zip(opts, singles):
            o.step(sk.siren_loss_grads(x, o.params, t1, acts=acts, sample_weights=s1)[1])

    host = {}
    for what, fn in (("batched call", batched), ("stacked Adam step", lambda: opt.step(grads)),
                     ("batched update", update),
                     ("3 Adam steps", lambda: [o.step(g) for o, g in zip(opts, grads1)]),
                     ("3 updates in turn", updates_in_turn)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(300):
            fn()
        torch.cuda.synchronize()
        host[what] = 1e3 * (time.perf_counter() - t0) / 300
    print("[times] 2-D ensemble update of the three directions on the host clock (300 in a "
          "row): " + ", ".join(f"{k} {v:.4f} ms" for k, v in host.items())
          + f"; batched kernel alone {row['ms']:.4f} ms (CUDA events)")
    return row


def phase_times(P: int, dims, errs: dict, launches: dict) -> list[dict]:
    import torch

    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    x, ws, target, g = _flagship_inputs(P, dims, seed=1)
    module = _siren_module(dims, ws)
    params = module.weights()

    def lib_forward():
        with torch.no_grad():
            module(x)

    def lib_loss_grads():
        loss = torch.mean((module(x) - target) ** 2)
        torch.autograd.grad(loss, params)

    module_frozen = _siren_module(dims, ws)
    module_frozen.requires_grad_(False)
    xr = x.clone().requires_grad_()

    def lib_fused_bwd():
        torch.autograd.grad(module_frozen(xr), xr, g)

    macs = _layer_macs(dims)
    fwd, chain = sum(macs), sum(macs[1:])
    bwd = sum(macs[:-1]) + chain + macs[0]  # K2, dx only: forward, chain, dx
    weight_bytes = 4 * sum(w.numel() for w in ws)
    in_bytes = 4 * x.numel()
    # the tensor-core route's bound: its bf16x3 products (three bf16
    # products for each float32 one) at the bf16 peak
    specs = [
        ("siren_forward_wg", "siren_wg", ":240", lambda: sk.siren_forward(x, ws),
         lambda: sk.siren_forward_ref(x, ws), lib_forward,
         3 * 2 * P * fwd, in_bytes + weight_bytes + 4 * P),
        ("siren_loss_grads_wg", "siren_wg", ":518", lambda: sk.siren_loss_grads(x, ws, target),
         lambda: sk.siren_loss_grads_ref(x, ws, target), lib_loss_grads, *_k1_work(P, dims, ws)),
        # as the main path calls it: dx for the PerturbNet step, no dW
        ("siren_fused_bwd_wg", "siren_wg", ":377",
         lambda: sk.siren_fused_bwd(x, ws, g, need_dw=False),
         lambda: sk.siren_fused_bwd_ref(x, ws, g, need_dw=False), lib_fused_bwd,
         3 * 2 * P * bwd, 2 * in_bytes + weight_bytes + 4 * P),
    ]
    rows = [_time_row(name, source, f"siren_kernel.py{line}", kern, plain, lib, flops,
                      nbytes, f"P={P}", errs, launches, peak=PEAK_BF16_TC)
            for name, source, line, kern, plain, lib, flops, nbytes in specs]
    from mri_super_resolution_tpu_torch.ops import _build

    def routes_in_turns(what, n, tc, simt, flops32):
        tc_ms, simt_ms = _best_alternating(tc, simt, 10, 2)
        print(f"[times] {what} at P={n}, routes in turns (best of 2): tensor-core "
              f"{tc_ms:.3f} ms ({flops32 / tc_ms / 1e9:.1f} float32-equivalent TFLOP/s, "
              f"{3 * flops32 / tc_ms / 1e9:.1f} TFLOP/s of bf16 products; bound "
              f"{3 * flops32 / PEAK_BF16_TC * 1e3:.3f} ms), SIMT {simt_ms:.3f} ms "
              f"({flops32 / simt_ms / 1e9:.1f} TFLOP/s; its f32 bound "
              f"{flops32 / PEAK_F32_FLOPS * 1e3:.3f} ms)")

    stream = _build.stream_ptr()
    routes_in_turns("K1", P, lambda: sk.siren_loss_grads(x, ws, target),
                    lambda: sk._launch_loss_grads(sk._lib(), x, ws, target, 30.0, P, stream),
                    2 * P * (2 * fwd + chain))
    routes_in_turns("K3", P, lambda: sk.siren_forward(x, ws),
                    lambda: sk._launch_forward(sk._lib(), x, ws, 30.0, stream), 2 * P * fwd)
    routes_in_turns("K2 (dx only)", P, lambda: sk.siren_fused_bwd(x, ws, g, need_dw=False),
                    lambda: sk._launch_fused_bwd(sk._lib(), x, ws, g, 30.0, False, True,
                                                 stream), 2 * P * bwd)
    _passes("K1", lambda: sk.siren_loss_grads(x, ws, target))
    _passes("K3", lambda: sk.siren_forward(x, ws))
    _passes("K2 (dx only)", lambda: sk.siren_fused_bwd(x, ws, g, need_dw=False))
    xc, wsc, _, _ = _flagship_inputs(INFER_CHUNK, dims, seed=2)
    routes_in_turns("K3 at the inference chunk", INFER_CHUNK, lambda: sk.siren_forward(xc, wsc),
                    lambda: sk._launch_forward(sk._lib(), xc, wsc, 30.0, stream),
                    2 * INFER_CHUNK * fwd)
    with torch.no_grad():
        plain_chunk = _time_ms(lambda: sk.siren_forward_ref(xc, wsc), 5)
    print(f"[times] K3 at the inference chunk P={INFER_CHUNK}: plain version "
          f"{plain_chunk:.3f} ms")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--pn_epochs", type=int, default=4)
    ap.add_argument("--master_steps", type=int, default=300,
                    help="steps of the 2-D ensemble's main run (3000 in the reference)")
    ap.add_argument("--master_seg", type=int, default=30,
                    help="its ensemble tail (150 in the reference)")
    ap.add_argument("--hybrid_epochs", type=int, default=40,
                    help="epochs of the hybrid fit's four SIRENs (2500 in the reference)")
    ap.add_argument("--fast_epochs", type=int, default=40,
                    help="epochs of the fast-preset grid patient (600 in the preset)")
    ap.add_argument("--hybrid_grid_epochs", type=int, default=600,
                    help="epochs of the hybrid fit's grid arm (600 in the fast preset, "
                         "2500 in the quality preset)")
    ap.add_argument("--pia_steps", type=int, default=PIA_STEPS,
                    help="pretraining steps of the PIA fitter (4000 in the pipeline)")
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
    phase_k1_trace(P, dims)
    phase_k1_trace(HYBRID_P, dims)
    errs.update(phase_k1_hybrid_parity(HYBRID_P, dims))
    errs.update(phase_k1_batched_parity(HYBRID_P, dims))
    phase_k4_trace(P)
    phase_k1a_trace()
    phase_pn_trace(P, dims)
    errs.update(phase_k1_variant_parity())
    errs.update(phase_k1w_batched_parity())
    errs.update(phase_k1a_lowres_parity())
    errs.update(phase_probe_parity())
    errs.update(phase_wire_parity(P))
    k6_err = phase_k6_parity()
    g1_err = phase_g1_parity()
    k7_err = phase_k7_parity()
    for inr_model in ("siren", "wire"):
        phase_small_patient(inr_model)
    phase_small_misr()
    with tempfile.TemporaryDirectory() as out_dir:
        phase_small_train(out_dir)
    phase_small_2d()
    launches = {}
    for inr_model in ("siren", "wire"):
        with tempfile.TemporaryDirectory() as out_dir:
            launches.update(phase_main_path(inr_model, args.epochs, args.pn_epochs,
                                            out_dir))
    hybrid_launches, hybrid_res, nlls_maps, gt = phase_hybrid(args.hybrid_epochs)
    launches.update(hybrid_launches)
    phase_pia(hybrid_res, nlls_maps, gt, args.pia_steps)
    del hybrid_res
    for preset, epochs, pn_epochs in (("quality", args.epochs, args.pn_epochs),
                                      ("fast", args.fast_epochs, 0)):
        with tempfile.TemporaryDirectory() as out_dir:
            phase_grid(preset, epochs, pn_epochs, out_dir)
    phase_grid_trace()
    phase_hybrid_grid(args.hybrid_grid_epochs)
    with tempfile.TemporaryDirectory() as out_dir:
        launches.update(phase_misr_main(out_dir))
    with tempfile.TemporaryDirectory() as out_dir:
        master_launches, _ = phase_master_main(out_dir, args.master_steps, args.master_seg)
        launches.update(master_launches)
    with tempfile.TemporaryDirectory() as out_dir:
        erd_launches, (erd_lr, erd_coords, erd_target) = phase_erd_main(out_dir, ERD_THRESHOLD)
        launches.update(erd_launches)
    phase_erd_routes(erd_lr, erd_coords, erd_target, ERD_THRESHOLD)
    with tempfile.TemporaryDirectory() as out_dir:
        launches.update(phase_lowres_main(out_dir))
    with tempfile.TemporaryDirectory() as out_dir:
        phase_small_clis(out_dir)
    phase_autodiff()
    with tempfile.TemporaryDirectory() as out_dir:
        phase_serve(out_dir)
    phase_export_main(args.epochs, args.pn_epochs)
    with tempfile.TemporaryDirectory() as out_dir:
        phase_qual(out_dir)
    with tempfile.TemporaryDirectory() as out_dir:
        launches.update(phase_probe_main(out_dir))
    with tempfile.TemporaryDirectory() as out_dir:
        phase_loaders(out_dir)
    with tempfile.TemporaryDirectory() as out_dir:
        phase_cohort(out_dir)
    with tempfile.TemporaryDirectory() as out_dir:
        launches.update(phase_sharded(P, dims, out_dir, erd_target))
    with tempfile.TemporaryDirectory() as out_dir:
        phase_examples(out_dir)
    with tempfile.TemporaryDirectory() as out_dir:
        train_launches, train_data = phase_train_main(out_dir)
        launches.update(train_launches)
        rows = phase_times(P, dims, errs, launches) + phase_wire_times(P, errs, launches)
        rows.append(phase_k1_hybrid_time(HYBRID_P, dims, errs, launches))
        rows.append(phase_k1_batched_time(HYBRID_P, dims, errs, launches))
        rows.append(phase_k1_shard_time(P, dims, errs, launches))
        rows += phase_shard_times(P, dims, errs, launches)
        rows.append(phase_k6_times(k6_err, launches))
        rows.append(phase_g1_times(g1_err, launches))
        rows.append(phase_k7_times(k7_err, launches))
        rows += phase_2d_times(errs, launches)
        rows.append(phase_k1w_batched_time(errs, launches))
        rows.append(phase_k1a_lowres_time(errs, launches))
        rows += phase_probe_times(errs, launches)
        phase_rams_forward_times()
        phase_train_step_times(train_data, out_dir)
    smi = _card()
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
