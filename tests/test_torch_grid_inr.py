"""The port's GridINR (``models/grid_inr.py``) against the JAX package's.

A small GridINR (2 levels, base 4, F 2, hidden 8, z_divisor 1) is
initialised by flax, its grids pushed to O(0.3) so that interpolation
errors would show, and converted with ``convert.grid_inr_from_flax``. Both
packages then run the gather path (at mgrid and at random coordinates), the
tensor path, the tensor-path MSE with its gradients (against the JAX
package's plain and z-bucketed value-and-grad), and dense inference
(against ``infer_tensor_grid_zbucket``), all on the CPU.

Measured gaps: outputs 2.4e-7 of values up to 0.81, the loss 6.0e-8, the
gradients 1.4e-6 of values up to 1.8 (7.5e-7 of the largest). Tolerances:
1e-5 absolute on outputs and the loss, 1e-5 of the largest magnitude on
each gradient (about 10x the gaps). The axis
interpolation matrices are compared bit for bit: the port computes the
knots' positions as ``jnp.linspace`` does (``torch.linspace`` rounds some of
them to the other side of ``floor``; XLA multiplies by the reciprocal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.core.coords import mgrid as jmgrid
from mri_super_resolution_tpu.models import grid_inr as jg
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.core.coords import mgrid
from mri_super_resolution_tpu_torch.models import GridINR, GridINR2D
from mri_super_resolution_tpu_torch.models import grid_inr as tg

torch.set_num_threads(2)

CFG = dict(num_levels=2, base_resolution=4, features_per_level=2, hidden=8, z_divisor=1)
# (nx, ny, nz, nb). The first puts samples on knots, where n - 1 is a
# multiple of R - 1 (3 and 7 for the two levels): x on every knot of both
# levels (n - 1 = 21), y of level 1 (7), z of level 0 (3); the others fall
# mostly between knots
SHAPES = [(22, 8, 4, 4), (7, 10, 5, 4), (9, 6, 3, 2)]
ATOL, GRAD_TOL = 1e-5, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=GRAD_TOL * np.abs(want).max())


@pytest.fixture(scope="module")
def models():
    jm = jg.GridINR(**CFG)
    rng = np.random.default_rng(1)
    p = jm.init(jax.random.key(0), jmgrid((2, 2, 2, 4)))
    p = jax.tree.map(lambda a: a + np.float32(0.3) * rng.normal(size=a.shape).astype(np.float32), p)
    tm = GridINR(**CFG)
    tm.load_state_dict(convert.grid_inr_from_flax(_np(p)))
    tm.requires_grad_(False)
    return jm, p, tm


def test_converter_covers_every_parameter(models):
    jm, p, tm = models
    sd = convert.grid_inr_from_flax(_np(p))
    assert set(sd) == set(tm.state_dict())
    for k, v in GridINR(**CFG, generator=torch.Generator().manual_seed(0)).state_dict().items():
        assert v.shape == sd[k].shape, k
    fresh = GridINR(**CFG, generator=torch.Generator().manual_seed(0))
    assert 0.0 <= float(fresh.grids[0].min()) and float(fresh.grids[0].max()) < 1e-4
    assert float(fresh.head[0].bias.abs().max()) == 0.0


@pytest.mark.parametrize("shape", SHAPES)
def test_axis_weights_bitwise(shape):
    for n in shape[:3]:
        for R in (2, 4, 8):
            j = np.asarray(jax.jit(jg._axis_weights, static_argnums=(0, 1))(n, R))
            np.testing.assert_array_equal(tg._axis_weights(n, R).numpy(), j)


@pytest.mark.parametrize("shape", SHAPES)
def test_gather_path_matches(models, shape):
    jm, p, tm = models
    c = np.asarray(jmgrid(shape))
    np.testing.assert_array_equal(mgrid(shape).numpy(), c)
    rng = np.random.default_rng(3)
    r = rng.uniform(-1.1, 1.1, (50, 4)).astype(np.float32)  # some outside [-1, 1]
    for coords in (c, r):
        want = np.asarray(jax.jit(jm.apply)(p, jnp.asarray(coords)))
        got = tm(torch.as_tensor(coords)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_tensor_path_matches(models, shape):
    jm, p, tm = models
    want = np.asarray(jax.jit(lambda q: jg.grid_inr_tensor_apply(jm, q, shape))(p))
    got = tg.grid_inr_tensor_apply(tm.params(), shape).numpy()
    assert got.shape == (int(np.prod(shape)), 1)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the two paths of the port agree on the grid itself
    np.testing.assert_allclose(got, tm(mgrid(shape)).numpy(), atol=ATOL)


def test_gather_grads_match(models):
    """The PerturbNet steps' gradient: through the gather path, with
    respect to the coordinates (and the params)."""
    jm, p, tm = models
    c = np.random.default_rng(4).uniform(-1, 1, (40, 4)).astype(np.float32)
    t = np.random.default_rng(5).uniform(0, 1, (40, 1)).astype(np.float32)
    jl = lambda q, x: jnp.mean((jm.apply(q, x) - t) ** 2)
    jgp, jgx = jax.jit(jax.grad(jl, argnums=(0, 1)))(p, jnp.asarray(c))
    leaves = [w.clone().requires_grad_() for w in tm.params()]
    x = torch.as_tensor(c).requires_grad_()
    loss = torch.mean((tg.grid_inr_apply(leaves, x) - torch.as_tensor(t)) ** 2)
    grads = torch.autograd.grad(loss, [*leaves, x])
    _grad_close(grads[-1], jgx)
    for g, w in zip(grads[:-1], convert.grid_inr_from_flax(_np(jgp)).values()):
        _grad_close(g, w)


@pytest.mark.parametrize("shape", SHAPES)
def test_tensor_loss_and_grads_match_plain_and_zbucket(models, shape):
    """The unpadded port fit step against the JAX package's plain tensor
    value-and-grad and its z-bucketed one (slice axis padded to a power of
    two, masked MSE over the true voxels)."""
    jm, p, tm = models
    nx, ny, nz, nb = shape
    target = np.random.default_rng(nz).uniform(0, 1, (int(np.prod(shape)), 1)).astype(np.float32)
    loss, grads = tg.make_tensor_value_and_grad(shape)(tm.params(), mgrid(shape),
                                                      torch.as_tensor(target))
    zb = jg.z_bucket_for(nz)
    assert zb > nz or nz == 4
    ref = [jax.jit(jg.make_tensor_value_and_grad(jm, shape))(p, jmgrid(shape),
                                                            jnp.asarray(target)),
           jax.jit(jg.make_zbucket_value_and_grad(jm, nx, ny, zb, nb))(
               p, jg.build_z_aux(jm, nz, zb), jg.pad_target_z(target, shape, zb))]
    for jl, jgr in ref:
        np.testing.assert_allclose(float(loss), float(jl), rtol=0, atol=ATOL)
        for g, w in zip(grads, convert.grid_inr_from_flax(_np(jgr)).values()):
            _grad_close(g, w)


@pytest.mark.parametrize("clamp", [None, 0.0])
def test_infer_tensor_grid_matches_zbucket(models, clamp):
    jm, p, tm = models
    shape = (11, 9, 5, 4)
    want = jg.infer_tensor_grid_zbucket(jm, p, shape, clamp_min=clamp)
    got = tg.infer_tensor_grid(tm.params(), shape, clamp_min=clamp)
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (11 * 9 * 5 * 4, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)
    if clamp is not None:
        assert (got >= 0).all() and (got == 0).any()


def test_grid_inr2d_matches():
    cfg = dict(num_levels=2, base_resolution=4, features_per_level=2, hidden=8)
    jm = jg.GridINR2D(**cfg)
    rng = np.random.default_rng(3)
    p = jm.init(jax.random.key(2), jnp.zeros((4, 2)))
    p = jax.tree.map(lambda a: a + np.float32(0.2) * rng.normal(size=a.shape).astype(np.float32), p)
    tm = GridINR2D(**cfg)
    sd = convert.grid_inr_from_flax(_np(p))
    assert "b_embedding" not in sd
    tm.load_state_dict(sd)
    c = np.random.default_rng(6).uniform(-1, 1, (64, 2)).astype(np.float32)
    np.testing.assert_allclose(tm(torch.as_tensor(c)).detach().numpy(),
                               np.asarray(jax.jit(jm.apply)(p, jnp.asarray(c))), atol=ATOL)
