"""Bounded nonlinear least squares of the 3-compartment model, all voxels at once.

Counterpart of ``mri_super_resolution_tpu/ops/nlls.py`` (``model_signal``
:36, ``_lm_single`` :50, ``hybrid_fit`` :102): the reference's per-voxel
scipy ``curve_fit`` (PIA.py:240-283) of

    S(b, TE) = 1000 [ V_ep exp(-b/1000 D_ep) exp(-TE/T2_ep)
                    + V_st exp(-b/1000 D_st) exp(-TE/T2_st)
                    + (1 - V_ep - V_st) exp(-b/1000 D_lu) exp(-TE/T2_lu) ]

over the 16-point (b, TE) grid, as a projected Levenberg-Marquardt
iteration with box bounds. The JAX package runs one voxel's ``while_loop``
under ``vmap``, which goes on while any lane is unfinished and freezes the
finished ones; here one loop runs every voxel as a batch, with a per-voxel
``done`` mask that freezes ``theta``, ``lam`` and the cost of finished
voxels, and ends when all are done or after ``iters`` steps. The Jacobian
is written out. A voxel whose cost ends non-finite falls back to p0 (the
reference's RuntimeError path, PIA.py:276-277).
"""
from __future__ import annotations

import numpy as np
import torch

BVALS = (0.0, 150.0, 1000.0, 1500.0)
TES = (0.0, 13.0, 93.0, 143.0)

# parameter vector: (D_ep, D_st, D_lu, T2_ep, T2_st, T2_lu, V_ep, V_st)
P0 = np.asarray([0.55, 1.3, 2.8, 50.0, 70.0, 750.0, 0.3, 0.4], np.float32)
LO = np.asarray([0.3, 0.7, 2.7, 20.0, 40.0, 500.0, 0.0, 0.0], np.float32)
HI = np.asarray([0.7, 1.7, 3.0, 70.0, 100.0, 1000.0, 1.0, 1.0], np.float32)


def _factors(theta: torch.Tensor, b: torch.Tensor, te: torch.Tensor):
    """Each compartment's (V_c, exp(-b/1000 D_c), exp(-TE/T2_c)) over the
    (..., 16) grid, V_lu = 1 - V_ep - V_st."""
    V_ep, V_st = theta[..., 6:7], theta[..., 7:8]
    V = (V_ep, V_st, 1.0 - V_ep - V_st)
    return [(V[c], torch.exp(-b / 1000.0 * theta[..., c:c + 1]),
             torch.exp(-te / theta[..., 3 + c:4 + c])) for c in range(3)]


def model_signal(theta: torch.Tensor, b: torch.Tensor, te: torch.Tensor) -> torch.Tensor:
    """The signal over the flattened (b, TE) grid for ``theta`` (..., 8);
    returns (..., 16). Products in the JAX package's order."""
    (v0, d0, t0), (v1, d1, t1), (v2, d2, t2) = _factors(theta, b, te)
    return 1000.0 * (v0 * d0 * t0 + v1 * d1 * t1 + v2 * d2 * t2)


def _jacobian(theta: torch.Tensor, b: torch.Tensor, te: torch.Tensor) -> torch.Tensor:
    """d model_signal / d theta, (N, 16, 8)."""
    f = _factors(theta, b, te)
    V = [v for v, _, _ in f]
    e = [d * t for _, d, t in f]
    cols = [-b * V[c] * e[c] for c in range(3)]  # d/dD_c
    cols += [1000.0 * V[c] * e[c] * te / theta[:, 3 + c:4 + c] ** 2 for c in range(3)]
    cols += [1000.0 * (e[0] - e[2]), 1000.0 * (e[1] - e[2])]  # d/dV_ep, d/dV_st
    return torch.stack(cols, dim=-1)


def _cost(theta, b, te, y) -> torch.Tensor:
    r = model_signal(theta, b, te) - y
    return (r * r).sum(-1)


@torch.no_grad()
def hybrid_fit(signals: torch.Tensor, bvals=BVALS, tes=TES, iters: int = 40,
               ftol: float = 1e-10):
    """Fit every voxel of ``signals`` (N, 16) (b outer, TE inner); returns
    (D (N, 3), T2 (N, 3), v (N, 3)) with v[:, 2] = 1 - V_ep - V_st.

    A step solves (JtJ + lam diag(max(diag JtJ, 1e-6))) delta = Jt r,
    projects theta - delta onto the bounds, and is taken when it lowers the
    cost (lam x 0.33) or refused (lam x 4), lam within [1e-8, 1e8]. A voxel
    is done when a taken step improves the cost by a relative amount under
    ``ftol`` or when a refused step finds lam at 1e8."""
    dev, dt = signals.device, torch.float32
    y = signals.to(dt)
    te_grid, b_grid = np.meshgrid(np.asarray(tes, np.float32), np.asarray(bvals, np.float32))
    b = torch.as_tensor(b_grid.reshape(-1), device=dev)
    te = torch.as_tensor(te_grid.reshape(-1), device=dev)
    lo, hi = torch.as_tensor(LO, device=dev), torch.as_tensor(HI, device=dev)
    N = y.shape[0]
    p0 = torch.as_tensor(P0, device=dev).expand(N, 8)
    theta = p0.clone()
    c0 = _cost(p0, b, te, y)
    c = c0.clone()
    lam = torch.full((N,), 1e-2, dtype=dt, device=dev)
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    eye = torch.eye(8, dtype=dt, device=dev)
    for _ in range(iters):
        if bool(done.all()):
            break
        J = _jacobian(theta, b, te)
        r = model_signal(theta, b, te) - y
        JtJ = J.transpose(1, 2) @ J
        g = (J.transpose(1, 2) @ r[..., None])[..., 0]
        scale = torch.clamp_min(torch.diagonal(JtJ, dim1=1, dim2=2), 1e-6)
        A = JtJ + lam[:, None, None] * eye * scale[:, None, :]
        delta, info = torch.linalg.solve_ex(A, g)
        delta = torch.where((info == 0)[:, None], delta, torch.full_like(delta, float("nan")))
        cand = torch.clamp(theta - delta, lo, hi)
        c_new = _cost(cand, b, te, y)
        accept = c_new < c
        rel_improve = (c - c_new) / torch.clamp_min(c, 1e-30)
        converged = (accept & (rel_improve < ftol)) | (~accept & (lam >= 1e8))
        live = ~done
        take = accept & live
        theta = torch.where(take[:, None], cand, theta)
        c = torch.where(take, c_new, c)
        lam = torch.where(live, torch.clamp(torch.where(accept, lam * 0.33, lam * 4.0),
                                            1e-8, 1e8), lam)
        done = done | (live & converged)
    bad = ~torch.isfinite(c) | (c > c0)
    theta = torch.where(bad[:, None], p0, theta)
    v = torch.stack([theta[:, 6], theta[:, 7], 1.0 - theta[:, 6] - theta[:, 7]], dim=-1)
    return theta[:, 0:3], theta[:, 3:6], v
