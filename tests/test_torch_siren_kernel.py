"""K1-K3 of the port against the JAX package's Pallas kernels.

On CPU tensors the port's wrappers run their plain PyTorch versions (the
CUDA kernels run only on the card: see ``tests/test_torch_cuda.py`` and
``chip_smoke.py``), and the JAX kernels run in Pallas interpret mode, as
``tests/test_pallas_kernel.py`` runs them. Hidden width 128, two hidden
layers, 400 rows: no tile divides 400, so the ragged tile is exercised.
Tolerances are those of the JAX package's own kernel-vs-autodiff tests
(``test_pallas_kernel.py``): forward atol 2e-4, loss rtol 1e-4, dW atol 5e-4,
dx atol 5e-3 -- the JAX kernel stashes activations in bf16, which is where
the gap to float32 comes from.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.models import Siren as JSiren
from mri_super_resolution_tpu.ops.pallas import siren_kernel as jk
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.ops import siren_kernel as tk

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(400, 128)).astype(np.float32)
    model = JSiren(hidden_features=128, hidden_layers=2)
    params = model.init(jax.random.key(0), jnp.asarray(x))
    jws = tuple(jk.weights_from_flax(params))  # flax layout (in, out)
    tws = convert.siren_weights(jax.tree.map(np.asarray, params))  # (out, in)
    target = rng.normal(size=(400, 1)).astype(np.float32)
    g = (rng.normal(size=(400, 1)) / 400).astype(np.float32)
    return model, params, x, jws, tws, target, g


def _flax_layout(grads):
    """Port grads (out, in) -> JAX kernel layout (in, out) as numpy."""
    return [g.T.numpy() if g.dim() == 2 else g.numpy() for g in grads]


def test_forward_matches_pallas(setup):
    _, _, x, jws, tws, _, _ = setup
    ref = np.asarray(jk.siren_forward(jnp.asarray(x), list(jws)))
    got = tk.siren_forward(torch.as_tensor(x), tws).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4)


@pytest.mark.parametrize("n_rows", [None, 350])
def test_loss_grads_matches_pallas(setup, n_rows):
    _, _, x, jws, tws, target, _ = setup
    loss_j, dws_j = jk.siren_loss_grads(jnp.asarray(x), jws, jnp.asarray(target),
                                        n_rows=n_rows)
    loss_t, dws_t = tk.siren_loss_grads(torch.as_tensor(x), tws,
                                        torch.as_tensor(target), n_rows=n_rows)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    for gt, gj in zip(_flax_layout(dws_t), dws_j):
        np.testing.assert_allclose(gt, np.asarray(gj), atol=5e-4)


def test_fused_bwd_matches_pallas(setup):
    """K2 against the JAX siren_fused backward for the upstream g: dx and
    dW/db (the kernel must produce dW when asked)."""
    _, _, x, jws, tws, _, g = setup
    gj = jnp.asarray(g)

    def f(xx, ws):
        return jnp.sum(jk.siren_fused(xx, ws, 30.0) * gj)

    dx_j, dws_j = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jws)
    dx_t, dws_t = tk.siren_fused_bwd(torch.as_tensor(x), tws, torch.as_tensor(g))
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), atol=5e-3)
    for gt, gjw in zip(_flax_layout(dws_t), dws_j):
        np.testing.assert_allclose(gt, np.asarray(gjw), atol=5e-4)
    dx_only, none = tk.siren_fused_bwd(torch.as_tensor(x), tws, torch.as_tensor(g),
                                       need_dw=False)
    assert none is None
    torch.testing.assert_close(dx_only, dx_t, rtol=0, atol=0)


def test_autograd_function_matches_jax_grad(setup):
    """siren_fused's autograd gradient (K3 forward, K2 backward) equals
    jax.grad through the Pallas siren_fused, for x and for the weights."""
    _, _, x, jws, tws, target, _ = setup
    tj = jnp.asarray(target)

    def loss_j(xx, ws):
        return jnp.mean((jk.siren_fused(xx, ws, 30.0) - tj) ** 2)

    gx_j, gw_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x), jws)
    xt = torch.as_tensor(x).requires_grad_()
    wt = [w.clone().requires_grad_() for w in tws]
    loss_t = torch.mean((tk.siren_fused(xt, wt) - torch.as_tensor(target)) ** 2)
    gx_t, *gw_t = torch.autograd.grad(loss_t, [xt, *wt])
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), atol=5e-3)
    for gt, gj in zip(_flax_layout(gw_t), gw_j):
        np.testing.assert_allclose(gt, np.asarray(gj), atol=5e-4)


def test_autograd_function_input_only(setup):
    """Frozen weights (the PerturbNet step): only dx flows, and it equals the
    plain version's."""
    _, _, x, _, tws, _, g = setup
    xt = torch.as_tensor(x).requires_grad_()
    (gx,) = torch.autograd.grad(tk.siren_fused(xt, tws), xt, torch.as_tensor(g))
    dx_ref, _ = tk.siren_fused_bwd_ref(torch.as_tensor(x), tws, torch.as_tensor(g),
                                       need_dw=False)
    torch.testing.assert_close(gx, dx_ref)


def test_cpu_runs_plain_versions_without_launching(setup):
    _, _, x, _, tws, target, g = setup
    tk.reset_launches()
    xt, tt, gt = torch.as_tensor(x), torch.as_tensor(target), torch.as_tensor(g)
    tk.siren_forward(xt, tws)
    tk.siren_loss_grads(xt, tws, tt)
    tk.siren_fused_bwd(xt, tws, gt)
    tk.siren_loss_grads(xt, tws, tt, sample_weights=tt, with_out_absmax=True)
    assert set(tk.LAUNCHES) == {"siren_forward", "siren_loss_grads",
                                "siren_loss_grads_weighted", "siren_loss_grads_absmax",
                                "siren_loss_grads_weighted_absmax", "siren_loss_grads_wg",
                                "siren_fused_bwd", "siren_forward_wg", "siren_fused_bwd_wg",
                                "siren_loss_grads_stream", "siren_loss_grads_weighted_stream",
                                "siren_loss_grads_absmax_stream",
                                "siren_loss_grads_weighted_absmax_stream",
                                "siren_loss_grads_wg_batched",
                                "siren_loss_grads_resident_tc_batched",
                                "siren_loss_grads_weighted_resident_tc_batched"}
    assert not any(tk.LAUNCHES.values())


def test_wrappers_refuse_what_the_kernels_do_not_take(setup):
    _, _, x, _, tws, target, _ = setup
    xt = torch.as_tensor(x)
    with pytest.raises(TypeError):
        tk.siren_forward(xt.double(), tws)
    with pytest.raises(ValueError):
        tk.siren_forward(xt.T, tws)  # wrong width
    with pytest.raises(ValueError):
        tk.siren_forward(xt.t().contiguous().t(), tws)  # non-contiguous
    with pytest.raises(ValueError):
        tk.siren_forward(xt, tws[:-2])  # last layer must have one output
    with pytest.raises(ValueError):
        tk.siren_loss_grads(xt, tws, torch.as_tensor(target), n_rows=0)
    with pytest.raises(ValueError):
        tk.siren_forward(xt.to("meta"), [w.to("meta") for w in tws])
