"""The port's RAMS network and kernel K6 against the JAX package: the Pallas
``conv3d_rfab`` in interpret mode and ``lax.conv`` (as
``tests/test_conv3d_kernel.py`` runs them), the flax ``WNConv`` / ``RFAB`` /
``RTAB`` / ``RAMS`` forward with ``conv_kernel`` on and off,
``fold_weight_norm``, and the committed RAMS checkpoint at full width.

On CPU tensors the K6 wrapper runs its plain PyTorch version (the CUDA
kernel runs only on the card: ``tests/test_torch_cuda.py``,
``chip_smoke.py``). Inputs come from a numpy seed; JAX-drawn params reach the
port through ``convert.py``.

Measured gaps (on the CPU; float32 unless named): plain K6 vs the Pallas
kernel 8.1e-6 and vs ``lax.conv`` 5.2e-6 (tol 2e-5, the JAX package's own);
in bf16 the plain K6 equals the Pallas kernel bit for bit and is within
0.040 of the float32 conv (tol 0.05, the JAX package's own). Small RAMS
(filters 8, N 2) vs flax in float32 1.2e-7 relative either route (tol rtol
2e-5, atol 2e-2, the JAX package's RAMS class); in bf16 the port is within
0.57 (library route) and 2.3 (K6 route) of the flax bf16 output, whose own
gap to the flax float32 output is 5.7 (the bound). The committed RAMS
(32, 12) on (2, 16, 16, 9): 1.2e-6 relative in float32 (tol as above); in
bf16 73.5 on both routes, against the flax model's own bf16-vs-float32 gap
of 121 (the bound; outputs reach 16,400); the port's K6 and library routes
differ by 73.5 in bf16, its own bf16-vs-float32 gap is 121.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.models import rams as jrams
from mri_super_resolution_tpu.ops.pallas.conv3d_kernel import conv3d_rfab as jconv3d_rfab
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.config import RAMSConfig
from mri_super_resolution_tpu_torch.models import rams as trams
from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(scale=3, filters=8, kernel_size=3, channels=9, r=4, N=2)
FULL = dict(scale=3, filters=32, kernel_size=3, channels=9, r=8, N=12)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _xla_conv(x, kernel, bias, padding):
    dn = jax.lax.conv_dimension_numbers(x.shape, kernel.shape, ("NDHWC", "DHWIO", "NDHWC"))
    out = jax.lax.conv_general_dilated(x, kernel, (1, 1, 1), padding, dimension_numbers=dn)
    return out + bias


def _conv_problem(shape, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, shape[-1], cout)) * 0.1).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    return x, k, b


# ---------------------------------------------------------------------------
# K6: plain version vs the Pallas kernel (interpret mode) and lax.conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,padding", [
    ((2, 8, 8, 5, 32), "SAME"),   # small RFAB-like
    ((1, 9, 7, 4, 32), "SAME"),   # H != W, short T
    ((1, 7, 6, 4, 32), "VALID"),  # the temporal-reduction convs
])
def test_k6_plain_matches_pallas_and_xla_f32(shape, padding):
    x, k, b = _conv_problem(shape, 32, seed=shape[1])
    pallas = np.asarray(jconv3d_rfab(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                     padding, interpret=True))
    xla = np.asarray(_xla_conv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), padding))
    ck.reset_launches()
    got = ck.conv3d_rfab(torch.as_tensor(x), torch.as_tensor(k), torch.as_tensor(b),
                         padding).numpy()
    assert ck.LAUNCHES["conv3d_rfab"] == 0  # CPU tensors: the plain version
    assert got.shape == pallas.shape == xla.shape
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, xla, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_k6_plain_matches_pallas_bf16(padding):
    """bf16 operands (the kernel rounded to bf16), f32 sums, one rounding:
    the Pallas kernel's compute_dtype=bfloat16 contract."""
    x, k, b = _conv_problem((1, 8, 8, 3, 32), 32, seed=5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    pallas = np.asarray(jconv3d_rfab(xb, jnp.asarray(k), jnp.asarray(b), padding,
                                     interpret=True, compute_dtype=jnp.bfloat16)
                        ).astype(np.float32)
    xla = np.asarray(_xla_conv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), padding))
    got = ck.conv3d_rfab(torch.as_tensor(x).bfloat16(), torch.as_tensor(k),
                         torch.as_tensor(b), padding)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, pallas, rtol=0.05, atol=0.05)
    np.testing.assert_allclose(got, xla, rtol=0.05, atol=0.05)


def test_k6_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 4, 3, 8)
    k, b = torch.zeros(3, 3, 3, 8, 8), torch.zeros(8)
    with pytest.raises(ValueError, match="multiples of 8"):
        ck.conv3d_rfab(torch.zeros(1, 4, 4, 3, 4), torch.zeros(3, 3, 3, 4, 8), b)
    with pytest.raises(ValueError, match="kernel must be"):
        ck.conv3d_rfab(x, torch.zeros(1, 1, 1, 8, 8), b)
    with pytest.raises(ValueError, match="VALID needs"):
        ck.conv3d_rfab(torch.zeros(1, 4, 4, 2, 8), k, b, "VALID")
    with pytest.raises(ValueError, match="padding"):
        ck.conv3d_rfab(x, k, b, "CAUSAL")
    with pytest.raises(TypeError):
        ck.conv3d_rfab(x.double(), k, b)
    with pytest.raises(ValueError, match="contiguous"):
        ck.conv3d_rfab(x.transpose(1, 2), k, b)


# ---------------------------------------------------------------------------
# layers and the network vs flax
# ---------------------------------------------------------------------------


def test_depth_to_space_and_reflect_pad():
    x = np.arange(2 * 3 * 2 * 18, dtype=np.float32).reshape(2, 3, 2, 18)
    np.testing.assert_array_equal(trams.depth_to_space(torch.as_tensor(x), 3).numpy(),
                                  np.asarray(jrams.depth_to_space(jnp.asarray(x), 3)))
    y = np.arange(2 * 5 * 4 * 3, dtype=np.float32).reshape(2, 5, 4, 3)
    np.testing.assert_array_equal(trams.reflect_pad_hw(torch.as_tensor(y)).numpy(),
                                  np.asarray(jrams.reflect_pad_hw(jnp.asarray(y))))


@pytest.mark.parametrize("layer", ["WNConv3d", "WNConv3d_valid", "WNConv2d", "RFAB", "RTAB"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("conv_kernel", [False, True])
def test_layers_match_flax(layer, dtype, conv_kernel):
    rng = np.random.default_rng(3)
    if layer.startswith("WNConv"):
        nd = 2 if layer == "WNConv2d" else 3
        pad = "VALID" if layer.endswith("valid") else "SAME"
        jm = jrams.WNConv(16, (3,) * nd, padding=pad, conv_kernel=conv_kernel)
        tm = trams.WNConv(8, 16, (3,) * nd, padding=pad, conv_kernel=conv_kernel)
        prefix = ""
    elif layer == "RFAB":
        nd = 3
        jm = jrams.RFAB(8, r=4, conv_kernel=conv_kernel)
        tm = trams.RFAB(8, r=4, conv_kernel=conv_kernel)
        prefix = "block"
    else:
        nd = 2
        jm, tm, prefix = jrams.RTAB(8, r=4), trams.RTAB(8, r=4), "block"
    x = rng.normal(size=(2, 6, 5, 4, 8)[:nd + 1] + (8,)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x).astype(jdt)
    params = jm.init(jax.random.key(1), xj)
    # perturb g and the bias off their ones/zeros init so that both count
    params = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)), params)
    ref = np.asarray(jm.apply(params, xj)).astype(np.float32)
    p = _np(params)["params"]
    if prefix:
        sd = {}
        convert._attention_block(sd, "b", p)
        sd = {k[2:]: v for k, v in sd.items()}
    else:
        sd = {k: torch.tensor(v) for k, v in p.items()}
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm(torch.as_tensor(x).to(getattr(torch, dtype))).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:  # a few bf16 ulps: the two frameworks sum and round in other orders
        np.testing.assert_allclose(got, ref, rtol=0, atol=4 * 2.0 ** -8 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("conv_kernel", [False, True])
def test_small_rams_matches_flax(dtype, conv_kernel):
    rng = np.random.default_rng(0)
    x = rng.uniform(7000, 8000, (2, 10, 12, 9)).astype(np.float32)
    jm = jrams.RAMS(**SMALL, compute_dtype=dtype, conv_kernel=conv_kernel)
    params = jm.init(jax.random.key(0), jnp.asarray(x))
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = trams.RAMS(**SMALL, compute_dtype=dtype, conv_kernel=conv_kernel)
    tm.load_state_dict(convert.rams_state_dict(_np(params)))
    with torch.inference_mode():
        got = tm(torch.as_tensor(x)).numpy()
    assert got.shape == ref.shape == (2, 30, 36, 1)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-2)
    else:
        # against the JAX model's own bf16-vs-f32 gap on the same input
        ref32 = np.asarray(jrams.RAMS(**SMALL).apply(params, jnp.asarray(x)))
        assert np.abs(got - ref).max() <= max(1.0, np.abs(ref - ref32).max())


def test_fold_weight_norm_matches_jax():
    x = np.random.default_rng(3).uniform(7000, 8000, (1, 12, 12, 9)).astype(np.float32)
    jm = jrams.RAMS(**SMALL)
    params = jm.init(jax.random.key(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: a * 1.5 + 0.01, params)  # g off its init
    folded_j = convert.rams_state_dict(_np(jrams.fold_weight_norm(params)))
    sd = convert.rams_state_dict(_np(params))
    folded_t = trams.fold_weight_norm(sd)
    assert folded_t.keys() == folded_j.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(folded_t[k], folded_j[k], rtol=1e-6, atol=1e-7)
    tm = trams.RAMS(**SMALL)
    with torch.no_grad():
        tm.load_state_dict(sd)
        a = tm(torch.as_tensor(x))
        tm.load_state_dict(folded_t)
        b = tm(torch.as_tensor(x))
    torch.testing.assert_close(b, a, rtol=2e-5, atol=2e-2)


def test_init_follows_flax_initialisers():
    gen = torch.Generator().manual_seed(0)
    tm = trams.RAMS(**SMALL, generator=gen)
    conv = tm.rfabs[0].conv0
    limit = np.sqrt(6.0 / (27 * 8 + 27 * 8))
    v = conv.v.detach().numpy()
    assert np.abs(v).max() <= limit and np.abs(v).max() > 0.9 * limit
    assert float(conv.g.detach().min()) == float(conv.g.detach().max()) == 1.0
    assert float(conv.bias.detach().abs().max()) == 0.0
    again = trams.RAMS(**SMALL, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(again.rfabs[0].conv0.v, conv.v, rtol=0, atol=0)
    assert set(tm.state_dict()) == set(convert.rams_state_dict(_np(jrams.RAMS(**SMALL).init(
        jax.random.key(0), jnp.zeros((1, 8, 8, 9))))))


def test_k6_gate_follows_the_jax_package():
    """Only the lane-aligned 3x3x3 convs take K6: the feature extraction
    (in_ch 1), the scale^2 head (9 features), the 1x1x1 attention convs and
    the 2-D path stay on the library conv."""
    tm = trams.RAMS(**FULL, conv_kernel=True)
    k6 = [n for n, m in tm.named_modules() if isinstance(m, trams.WNConv) and m.use_k6]
    assert len(k6) == 2 * 12 + 1 + 3 * 3 == 34
    assert not any(n.startswith(("head", "to_scale", "rtab", "global_conv")) or "att" in n
                   for n in k6)


def test_nthwc_layout_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 17"):
        RAMSConfig(layout="nthwc")


# ---------------------------------------------------------------------------
# the committed checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def committed():
    from mri_super_resolution_tpu.utils import restore_pytree, unwrap_trainer_params

    return unwrap_trainer_params(restore_pytree(os.path.join(REPO, "artifacts",
                                                             "rams_dwi_params")))


def test_committed_npz_equals_orbax_checkpoint(committed):
    """The port's ``artifacts/rams_dwi_params.npz`` holds the orbax checkpoint
    ``artifacts/rams_dwi_params`` leaf for leaf. It was written once, from
    the repository root, with:

        python -c "from mri_super_resolution_tpu.utils import restore_pytree, \\
            unwrap_trainer_params; from mri_super_resolution_tpu_torch.convert \\
            import save_params_npz, RAMS_PARAMS_NPZ; save_params_npz( \\
            unwrap_trainer_params(restore_pytree('artifacts/rams_dwi_params')), \\
            RAMS_PARAMS_NPZ)"
    """
    npz = convert.load_params_npz(convert.RAMS_PARAMS_NPZ)
    a = jax.tree_util.tree_leaves_with_path(committed)
    b = jax.tree_util.tree_leaves_with_path(npz)
    assert [jax.tree_util.keystr(k) for k, _ in a] == [jax.tree_util.keystr(k) for k, _ in b]
    assert len(b) == 213 and sum(v.size for _, v in b) == 958_129
    for (k, u), (_, v) in zip(a, b):
        assert v.dtype == np.float32 and np.array_equal(np.asarray(u), v), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_committed_rams_matches_flax(committed, dtype):
    """The full-width committed RAMS (32, 12) through both packages; the
    port with K6's plain version on (the route the card runs) and off. In
    bf16 the two routes of the port also differ by less than the port's own
    bf16-vs-float32 gap (the bound chip_smoke.py puts on them at twice
    that)."""
    x = np.random.default_rng(0).uniform(6000, 9000, (2, 16, 16, 9)).astype(np.float32)
    ref = np.asarray(jrams.RAMS(**FULL, compute_dtype=dtype).apply(committed, jnp.asarray(x)))
    sd = convert.rams_state_dict(_np(committed))
    got = {}
    for conv_kernel in (False, True):
        tm = trams.RAMS(**FULL, compute_dtype=dtype, conv_kernel=conv_kernel)
        tm.load_state_dict(sd)
        with torch.inference_mode():
            got[conv_kernel] = tm(torch.as_tensor(x)).numpy()
        assert got[conv_kernel].shape == (2, 48, 48, 1)
        if dtype == "float32":
            np.testing.assert_allclose(got[conv_kernel], ref, rtol=2e-5, atol=2e-2)
        else:
            # bf16 rounds at other places in the two frameworks; bound the
            # gap by the JAX model's own bf16-vs-f32 gap on this input
            ref32 = np.asarray(jrams.RAMS(**FULL).apply(committed, jnp.asarray(x)))
            assert np.abs(got[conv_kernel] - ref).max() <= np.abs(ref - ref32).max()
    if dtype == "bfloat16":
        tm = trams.RAMS(**FULL)
        tm.load_state_dict(sd)
        with torch.inference_mode():
            own32 = tm(torch.as_tensor(x)).numpy()
        assert np.abs(got[True] - got[False]).max() < np.abs(got[False] - own32).max()
