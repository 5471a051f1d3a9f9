"""The port's NLLS tissue fit (``ops/nlls.py``) and PIDS maps
(``ops/pids.py``) against the JAX package's, on the CPU.

NLLS voxels: one slice of a seeded three-compartment synthetic patient
(``hybrid_from_tissue``, 24x24, acquisitions averaged, normalised by its
(b0, TE0) channel x 1000 as ``tissue_maps`` does): 576 voxels. Where the
accept/reject test of an LM step is near a tie, float32 rounding can send a
voxel down another path, so the parameters are held per voxel, as a share:
measured at 40 iterations, 99.1% of the voxels agree within 1e-4 of each
parameter's bound range and all within 4.2e-3; the fitted cost of every
voxel within 7.5e-5 relative (10 iterations: 99.7%, 3.9e-4, 7.2e-5).
Tolerances: at least 98% of the voxels within 1e-4 of the range, all within
1e-2, every cost within 1e-3. Garbage voxels (NaN, infinite) fall back to p0
on both sides, exactly. The PIDS maps are 0/1 flags and must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.ops import nlls as jn
from mri_super_resolution_tpu.ops import pids as jp
from mri_super_resolution_tpu_torch.data import synthetic
from mri_super_resolution_tpu_torch.ops import nlls as tn
from mri_super_resolution_tpu_torch.ops import pids as tp
from mri_super_resolution_tpu_torch.pipelines.hybrid import mean_over_acquisitions

torch.set_num_threads(2)

BV = np.asarray([0.0, 150.0, 1000.0, 1500.0], np.float32)
SHARE, CLOSE, ALL, COST_RTOL = 0.98, 1e-4, 1e-2, 1e-3


def _grid():
    te_grid, b_grid = np.meshgrid(tn.TES, tn.BVALS)
    return (torch.tensor(b_grid.reshape(-1), dtype=torch.float32),
            torch.tensor(te_grid.reshape(-1), dtype=torch.float32))


@pytest.fixture(scope="module")
def hybrid_slice():
    """(24, 24, 4 b, 4 TE) de-normalised hybrid slice of a tissue phantom."""
    rng = np.random.default_rng(0)
    b0 = (1000 * np.abs(rng.normal(1.0, 0.2, (24, 24, 2)))).astype(np.float32)
    hy, _ = synthetic.hybrid_from_tissue(b0, acq_counts=(1, 2, 2, 2), seed=3)
    h = mean_over_acquisitions(hy)
    rh = np.stack([np.stack([h[b][te] for te in range(4)], -1) for b in range(4)], -2)
    return rh[:, :, 1]


def test_model_signal_matches():
    rng = np.random.default_rng(1)
    theta = (tn.LO + rng.uniform(size=(64, 8)) * (tn.HI - tn.LO)).astype(np.float32)
    b, te = _grid()
    want = np.stack([np.asarray(jn.model_signal(jnp.asarray(t), jnp.asarray(b.numpy()),
                                                jnp.asarray(te.numpy()))) for t in theta])
    got = tn.model_signal(torch.as_tensor(theta), b, te).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    # one voxel without a batch axis, as the JAX function takes it
    np.testing.assert_allclose(tn.model_signal(torch.as_tensor(theta[0]), b, te).numpy(),
                               want[0], rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("iters", [40, 10])
def test_hybrid_fit_matches_on_tissue_voxels(hybrid_slice, iters):
    norm = 1000.0 * hybrid_slice / (hybrid_slice[:, :, 0:1, 0:1] + 1e-7)
    sig = norm.reshape(-1, 16).astype(np.float32)
    jD, jT, jv = (np.asarray(a) for a in jn.hybrid_fit(jnp.asarray(sig), iters=iters))
    tD, tT, tv = (a.numpy() for a in tn.hybrid_fit(torch.as_tensor(sig), iters=iters))
    np.testing.assert_allclose(tv.sum(-1), 1.0, atol=1e-5)
    jt = np.concatenate([jD, jT, jv[:, :2]], -1)
    tt = np.concatenate([tD, tT, tv[:, :2]], -1)
    assert (tt >= tn.LO).all() and (tt <= tn.HI).all()
    per_voxel = (np.abs(tt - jt) / (tn.HI - tn.LO)).max(-1)
    assert (per_voxel < CLOSE).mean() >= SHARE, (per_voxel < CLOSE).mean()
    assert per_voxel.max() < ALL
    b, te = _grid()
    y = torch.as_tensor(sig)
    cj = tn._cost(torch.as_tensor(jt), b, te, y)
    ct = tn._cost(torch.as_tensor(tt), b, te, y)
    assert float(((ct - cj).abs() / cj).max()) < COST_RTOL
    # the fit moved the voxels off p0 and lowered their cost (median 0.53 of
    # the cost at p0 at 40 iterations)
    c0 = tn._cost(torch.as_tensor(tn.P0).expand_as(y[:, :8]), b, te, y)
    assert bool((ct <= c0).all()) and float((ct / c0).median()) < 0.75


def test_garbage_falls_back_to_p0():
    sig = np.stack([np.full(16, np.nan), np.full(16, np.inf), np.full(16, -np.inf),
                    np.r_[np.nan, np.ones(15)]]).astype(np.float32)
    for iters in (10, 40):
        jD, jT, jv = (np.asarray(a) for a in jn.hybrid_fit(jnp.asarray(sig), iters=iters))
        tD, tT, tv = (a.numpy() for a in tn.hybrid_fit(torch.as_tensor(sig), iters=iters))
        p0 = np.broadcast_to(tn.P0, (4, 8))
        np.testing.assert_array_equal(np.concatenate([tD, tT, tv[:, :2]], -1), p0)
        np.testing.assert_array_equal(np.concatenate([jD, jT, jv[:, :2]], -1), p0)
        np.testing.assert_array_equal(tv, jv)


def test_detect_pids_slice_matches(hybrid_slice):
    rng = np.random.default_rng(2)
    S = rng.uniform(1, 1000, (6, 5, 4, 4)).astype(np.float32)
    S[0, 0, :, 0] = [1000.0, 1.0, 1e-3, 1e-5]  # ADC > 3
    S[1, 1, :, 0] = [10.0, 50.0, 200.0, 500.0]  # ADC < 0
    S[2, 2, 1, :] = [100.0, 100.4, 99.0, 99.5]  # a decay under one unit, truncated
    for s in (S, hybrid_slice.astype(np.float32)):
        want = jp.detect_pids_slice(jnp.asarray(BV), jnp.asarray(s))
        got = tp.detect_pids_slice(BV, torch.as_tensor(s))
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    a1, a2, _, _ = tp.detect_pids_slice(BV, torch.as_tensor(S))
    assert a1[0, 0] == 1 and a2[1, 1] == 1


@pytest.mark.parametrize("weights", [(1.0, 0.0), (0.7, 0.1)])
def test_pids_weight_map_matches(weights):
    rng = np.random.default_rng(3)
    S = rng.uniform(1, 1000, (5, 7, 4, 4)).astype(np.float32)
    want = np.asarray(jp.pids_weight_map(jnp.asarray(BV), jnp.asarray(S), *weights))
    got = tp.pids_weight_map(BV, torch.as_tensor(S), *weights)
    assert got.shape == (5, 7) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) <= set(np.float32(weights))
