"""Cohort runner: every patient fitted at once, cases spread over ranks.

Counterpart of ``mri_super_resolution_tpu/pipelines/cohort.py``
(BASELINE.json config 5, "cohort run: all 10 patients, vmapped slice
batches + pmap across chips"; the reference ran each patient as its own
SLURM job, run.sh). The per-case SIREN fits run as one batched program
(``parallel/sharded_fit.py:make_cohort_fit``); with several ranks the case
axis is spread over them and each rank fits its cases.

Per-case work mirrors master.py's per-direction slice fit: Normalize(0.5,
0.5) pixels of the cancer slice's ROI mean, Siren(2 -> hidden x layers),
Adam at 3e-4 (or with moment restarts). The JAX package's cohort fit is
plain autodiff, and so is this one: no hand kernel runs here.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from mri_super_resolution_tpu_torch import resolve_device
from mri_super_resolution_tpu_torch.core.coords import mgrid
from mri_super_resolution_tpu_torch.core.normalize import to_tensor_normalize
from mri_super_resolution_tpu_torch.data.cases import Case
from mri_super_resolution_tpu_torch.fit.optim import Adam
from mri_super_resolution_tpu_torch.models import Siren
from mri_super_resolution_tpu_torch.ops.siren_kernel import siren_forward_ref
from mri_super_resolution_tpu_torch.parallel.distributed import process_info
from mri_super_resolution_tpu_torch.parallel.mesh import (
    Spec, all_gather_cat, make_mesh, shard_batch)
from mri_super_resolution_tpu_torch.parallel.sharded_fit import make_cohort_fit, stack_params


@dataclasses.dataclass
class CohortResult:
    recons: np.ndarray  # (C, H, W) fitted mean-slice reconstructions
    losses: np.ndarray  # (C, steps)
    voxels_per_sec: float
    mesh_shape: dict


def case_seeds(seed: int, n: int) -> list[int]:
    """One generator seed a case, spawned from ``seed``."""
    return [int(s.generate_state(1)[0]) for s in np.random.SeedSequence(seed).spawn(n)]


def _apply(params, x):
    return siren_forward_ref(x, params)


def run_cohort(cases: Sequence[Case], num_steps: int = 1000, hidden_features: int = 64,
               hidden_layers: int = 6, learning_rate: float = 3e-4,
               roi: tuple[int, int] = (40, 100), case_axis: int | None = None,
               seed: int = 0, inr_restart_every: int = 0,
               init_params: Sequence[Sequence[torch.Tensor]] | None = None,
               device: str | torch.device = "cuda") -> CohortResult:
    """Fit each case's cancer-slice ROI mean image, every case at once.

    ``init_params``: one ``Siren.weights()``-ordered list a case (default:
    a ``Siren`` drawn from a ``torch.Generator`` of :func:`case_seeds`).
    ``case_axis``: ranks along the case axis (default: the widest that
    divides both the ranks and the cases); the remaining ranks share each
    case's voxels. Every rank returns every case. ``voxels_per_sec`` leaves
    out a two-step warm-up."""
    dev = resolve_device(device)
    r0, r1 = roi
    H = r1 - r0
    targets = np.stack([to_tensor_normalize(case.dwi[r0:r1, r0:r1, case.cancer_slice, :]
                                            .mean(-1)).reshape(-1, 1) for case in cases])
    C = len(cases)
    targets = torch.as_tensor(targets.astype(np.float32), device=dev)

    _, n_ranks = process_info()
    if case_axis is None:
        case_axis = next(c for c in range(min(C, n_ranks), 0, -1)
                         if n_ranks % c == 0 and C % c == 0)
    mesh = make_mesh(case=case_axis)

    coords = mgrid((H, H), device=dev)
    coords_stack = coords.expand(C, *coords.shape)
    if init_params is None:
        init_params = []
        for s in case_seeds(seed, C):
            model = Siren(2, hidden_features, hidden_layers, 1,
                          generator=torch.Generator().manual_seed(s))
            init_params.append([w.detach() for w in model.weights()])
    params_stack = [p.to(dev) for p in stack_params(init_params)]

    def opt_fn(p):
        return Adam(p, learning_rate, restart_every=inr_restart_every)

    local_params = [shard_batch(p, mesh, Spec("case")) for p in params_stack]
    local_coords = shard_batch(coords_stack, mesh, Spec("case", "data"))
    local_targets = shard_batch(targets, mesh, Spec("case", "data"))
    make_cohort_fit(_apply, opt_fn, mesh, min(2, num_steps))(
        local_params, local_coords, local_targets)
    fit = make_cohort_fit(_apply, opt_fn, mesh, num_steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = fit(local_params, local_coords, local_targets)
    losses = res.losses.cpu()  # waits for the fit
    dt = time.perf_counter() - t0

    with torch.no_grad():
        recons = torch.func.vmap(_apply)(res.params, coords.expand(len(res.params[0]),
                                                                   *coords.shape))
    recons = all_gather_cat(recons, mesh, "case")
    losses = all_gather_cat(losses, mesh, "case")
    return CohortResult(
        recons=recons.reshape(C, H, H).cpu().numpy(),
        losses=losses.numpy(),
        voxels_per_sec=C * coords.shape[0] * num_steps / dt,
        mesh_shape=mesh.shape,
    )
