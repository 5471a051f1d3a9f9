"""Multi-rank dry run: every parallel program of the port on ``n`` ranks.

Counterpart of ``__graft_entry__.dryrun_multichip`` of the JAX package.
:func:`dryrun_multiprocess` spawns ``n`` ranks on this host and runs on
each, with parity against one rank where the JAX dry run has it:
- a cohort step on a (case, data) mesh;
- the voxel-data-parallel fit, its losses against one rank's fit of the
  whole batch (rtol 1e-4);
- the padded fit (``n_rows``) against one rank's unpadded fit (rtol 1e-4);
- the tensor-parallel fit on a (data, model) mesh against one rank
  (rtol 1e-4);
- the RAMS trainer's batch data parallelism on a ragged batch: its step
  losses against one rank's (rtol 1e-4), then ``fit`` over a ragged epoch;
- the remaining fit programs with the voxel rows sharded over the data
  axis, as the JAX dry run runs them under its mesh, each against one rank
  (rtol 1e-4): ``fit_ensemble_batched`` (one direction, A = 3, 4 steps,
  ``seg`` 2, its predictions gathered), ``fit_alternating_pn`` (a SIREN of
  width 64 x 2 on a mapping of 8, a PerturbNet of width 16, 4 epochs, 2 of
  them PN) and ``fit_until`` (threshold 5e-2, at most 50 steps; the stop
  step equal).

Run it on the CPU (gloo) with ``python -m
mri_super_resolution_tpu_torch.parallel.dryrun 2 cpu``, or on a card with
``... 2 cuda`` (the ranks share it over gloo).
"""
from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

RTOL, ATOL = 1e-4, 1e-6
# each rank's keys of its worst relative gaps against one rank
CHECKS = ("dp", "padded", "tp", "trainer", "ensemble", "alternating", "until")


def _close(a, b, what: str) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not np.allclose(a, b, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{what} parity failed: {a} vs one rank {b}")
    return float(np.max(np.abs(a - b) / (np.abs(b) + 1e-12)))


def _rank_checks(device: str) -> dict:
    """Every check on this rank (called in each spawned process)."""
    import torch.distributed as dist

    from mri_super_resolution_tpu_torch.config import RAMSConfig, TrainerConfig
    from mri_super_resolution_tpu_torch.core.coords import mgrid
    from mri_super_resolution_tpu_torch.fit.optim import Adam
    from mri_super_resolution_tpu_torch.fit.trainer import Trainer
    from mri_super_resolution_tpu_torch.models import Siren
    from mri_super_resolution_tpu_torch.ops.siren_kernel import siren_forward_ref
    from mri_super_resolution_tpu_torch.parallel import (
        Spec, make_cohort_fit, make_mesh, make_sharded_fit, make_tp_fit, make_tp_mesh,
        pad_to_multiple, shard_batch, siren_tp_specs, stack_params)
    from mri_super_resolution_tpu_torch.pipelines.misr import build_rams

    torch.set_num_threads(2)
    rank, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device(device)
    out: dict = {"rank": rank}

    def apply(p, x):
        return siren_forward_ref(x, p)

    def adam(lr):
        return lambda p: Adam(p, lr)

    def siren(seed):
        m = Siren(2, 64, 2, 1, generator=torch.Generator().manual_seed(seed), device=dev)
        m.requires_grad_(False)
        return m

    case = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(case=case)
    data = n // case
    side = 8 * data
    coords = mgrid((side, side), device=dev)
    target = torch.sin(3.0 * coords[:, :1]) * torch.cos(2.0 * coords[:, 1:2])
    P = coords.shape[0]

    # cohort step: per-case params over 'case', voxels over 'data'
    stack = stack_params([siren(s).weights() for s in range(case)])
    res = make_cohort_fit(apply, adam(1e-4), mesh, 1)(
        [shard_batch(p, mesh, Spec("case")) for p in stack],
        shard_batch(coords.expand(case, P, 2), mesh, Spec("case", "data")),
        shard_batch(target.expand(case, P, 1), mesh, Spec("case", "data")))
    if res.losses.shape != (1, 1) or not bool(torch.isfinite(res.losses).all()):
        raise AssertionError(f"cohort step: losses {res.losses}")

    # voxel data parallelism against one rank
    steps = 3
    flat = make_mesh(case=1)
    one = make_mesh(1, 1, ranks=[rank])
    m = siren(0)
    res_n = make_sharded_fit(apply, adam(1e-4), flat, steps)(
        m.weights(), shard_batch(coords, flat), shard_batch(target, flat))
    res_1 = make_sharded_fit(apply, adam(1e-4), one, steps)(m.weights(), coords, target)
    out["dp"] = _close(res_n.losses.cpu(), res_1.losses.cpu(), "data-parallel")

    # a ragged voxel count: the padding leaves loss and gradient
    ragged = P - 3
    cpad, n_real = pad_to_multiple(coords[:ragged], n)
    tpad, _ = pad_to_multiple(target[:ragged], n)
    m = siren(9)
    res_m = make_sharded_fit(apply, adam(1e-4), flat, steps, n_rows=n_real)(
        m.weights(), shard_batch(cpad, flat), shard_batch(tpad, flat))
    res_u = make_sharded_fit(apply, adam(1e-4), one, steps)(
        m.weights(), coords[:ragged], target[:ragged])
    out["padded"] = _close(res_m.losses.cpu(), res_u.losses.cpu(), "padded-mask")

    # tensor parallelism on a (data, model) mesh
    p2 = n & -n
    model_ax = min(max(p2 // 2, 1), 64)
    tp_mesh = make_tp_mesh(data=n // model_ax, model=model_ax)
    m = siren(6)
    specs = siren_tp_specs(m)
    res_tp = make_tp_fit(m, adam(1e-3), tp_mesh, steps, specs)(m.weights(), coords, target)
    res_tp1 = make_tp_fit(m, adam(1e-3), make_tp_mesh(1, 1, ranks=[rank]), steps, specs)(
        m.weights(), coords, target)
    out["tp"] = _close(res_tp.losses.cpu(), res_tp1.losses.cpu(), "tensor-parallel")
    out["tp_mesh"] = tp_mesh.shape

    # the RAMS trainer: a batch of n + 1 samples, the second batch ragged
    rng = np.random.default_rng(0)
    x = rng.uniform(7000, 8000, (n + 1, 6, 6, 9)).astype(np.float32)
    y = rng.uniform(7000, 8000, (n + 1, 18, 18, 1)).astype(np.float32)
    mk = np.ones_like(y)
    cfg = RAMSConfig(filters=4, N=1, r=2)
    init = build_rams(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    losses = {}
    with tempfile.TemporaryDirectory() as tdir:
        for which, trainer_mesh in (("ranks", flat), ("one", None)):
            model = build_rams(cfg)
            model.load_state_dict(init)
            tcfg = TrainerConfig(batch_size=n, epochs=1, hr_size=18,
                                 checkpoint_dir=os.path.join(tdir, which, "ckpt"),
                                 log_dir=os.path.join(tdir, which, "logs"))
            tr = Trainer(model, tcfg, device=device, mesh=trainer_mesh)
            tr.init()
            losses[which] = [float(tr.train_step([tr._batch(idx, x, y, mk)])[0])
                             for idx in (np.arange(n), np.arange(n, n + 1))]
            if which == "ranks":
                state = tr.fit(x, (y, mk), seed=0)
                if state.step != 2 or not all(bool(torch.isfinite(p).all())
                                               for p in model.parameters()):
                    raise AssertionError(f"trainer fit: step {state.step}")
    out["trainer"] = _close(losses["ranks"], losses["one"], "RAMS trainer batch-DP")
    out.update(_fit_programs(flat, one, coords, target, dev))
    return out


def _fit_programs(flat, one, coords, target, dev) -> dict:
    """``fit_ensemble_batched``, ``fit_alternating_pn`` and ``fit_until``
    on ``flat``'s shards against the whole batch on a mesh of one."""
    from mri_super_resolution_tpu_torch.core.coords import fourier_encode, fourier_matrix
    from mri_super_resolution_tpu_torch.fit.engine import (fit_alternating_pn,
                                                          fit_ensemble_batched, fit_until)
    from mri_super_resolution_tpu_torch.fit.optim import Adam, StackedAdam
    from mri_super_resolution_tpu_torch.models import PerturbNet, Siren, perturbnet_apply
    from mri_super_resolution_tpu_torch.ops.siren_kernel import (siren_forward_batched_ref,
                                                                 siren_forward_ref)
    from mri_super_resolution_tpu_torch.parallel import Spec, shard_batch

    def on(mesh, x, spec=None):
        return x if mesh is one else shard_batch(x, mesh, spec)

    def siren(seed, d_in=2):
        m = Siren(d_in, 64, 2, 1, generator=torch.Generator().manual_seed(seed), device=dev)
        m.requires_grad_(False)
        return m

    out = {}
    A = 3
    pixels = target.expand(1, A, -1, 1).contiguous()
    wts = torch.ones_like(pixels)
    init = [w[None] for w in siren(1).weights()]
    ens = {}
    for name, mesh in (("ranks", flat), ("one", one)):
        ens[name] = fit_ensemble_batched(
            lambda p, x: siren_forward_batched_ref(x, p), StackedAdam(init, 1e-4),
            on(mesh, coords), on(mesh, pixels, Spec(None, None, "data")),
            on(mesh, wts, Spec(None, None, "data")), on(mesh, coords), on(mesh, coords),
            total_steps=4, seg=2, mesh=mesh)
    if ens["ranks"].pred_1x.shape != (1, coords.shape[0], 1):
        raise AssertionError(f"fit_ensemble: pred_1x {tuple(ens['ranks'].pred_1x.shape)}")
    out["ensemble"] = max(
        _close(ens["ranks"].losses.cpu(), ens["one"].losses.cpu(), "fit_ensemble"),
        _close(ens["ranks"].pred_1x.cpu(), ens["one"].pred_1x.cpu(), "fit_ensemble pred"))

    gen = torch.Generator().manual_seed(2)
    B = fourier_matrix(gen, 8, coords.shape[-1], 0.5, device=dev)
    ff = fourier_encode(coords, B)
    inr = siren(3, ff.shape[1])
    pn = PerturbNet(ff.shape[1], 16, coords.shape[-1], generator=gen, device=dev)
    alt = {}
    for name, mesh in (("ranks", flat), ("one", one)):
        alt[name] = fit_alternating_pn(
            lambda p, x: siren_forward_ref(x, p), perturbnet_apply,
            Adam([w.clone() for w in inr.weights()], 1e-4),
            Adam([w.detach().clone() for w in pn.weights()], 3e-4), on(mesh, ff),
            on(mesh, target), on(mesh, pixels[0], Spec(None, "data")), B, num_epochs=4,
            pn_epochs=2, mesh=mesh)
    out["alternating"] = _close(alt["ranks"].losses.cpu(), alt["one"].losses.cpu(),
                                "fit_alternating_pn")

    first = siren(5).weights()
    until = {}
    for name, mesh in (("ranks", flat), ("one", one)):
        until[name] = fit_until(lambda p, x: siren_forward_ref(x, p), 1e-3,
                                lambda k: [w.clone() for w in first], on(mesh, coords),
                                on(mesh, target), loss_threshold=5e-2, max_steps=50, mesh=mesh)
    if until["ranks"].steps != until["one"].steps:
        raise AssertionError(f"fit_until stopped at {until['ranks'].steps}, one rank at "
                             f"{until['one'].steps}")
    out["until"] = _close(until["ranks"].losses, until["one"].losses, "fit_until")
    out["until_steps"] = until["ranks"].steps
    return out


def dryrun_multiprocess(n: int, device: str = "cpu", timeout: float = 600.0) -> list[dict]:
    """Spawn ``n`` ranks and run every check on each; raises on any
    failure. Returns each rank's worst relative loss gaps."""
    from mri_super_resolution_tpu_torch.parallel.distributed import spawn_ranks

    results = spawn_ranks(_rank_checks, n, device, device=device, timeout=timeout)
    worst = max(r[k] for r in results for k in CHECKS)
    print(f"dryrun_multiprocess OK: {n} ranks on {device}: cohort step, data-parallel fit "
          f"(+ padded-mask parity), tensor-parallel fit {results[0]['tp_mesh']}, RAMS "
          f"trainer batch-DP, sharded fit_ensemble/fit_alternating_pn/fit_until (stop at "
          f"step {results[0]['until_steps']}); worst relative loss gap against one rank "
          f"{worst:.2e}")
    return results


if __name__ == "__main__":
    dryrun_multiprocess(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                        sys.argv[2] if len(sys.argv) > 2 else "cpu")
