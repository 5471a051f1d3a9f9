"""K1's sample-weighted and absmax/ReLU variants (and K2/K3 with ReLU codes)
of the port against the JAX package's Pallas kernels in interpret mode.

On CPU tensors the port's wrappers run their plain PyTorch versions; the
JAX kernels run in Pallas interpret mode. The plain Siren is 2 -> 32x3 -> 1
(the 2-D ensemble's layout, narrowed), the SirenERD 2 -> 32x2 -> 32 ReLU ->
1 ReLU (INR_ERD's, narrowed), on 400 rows: no tile divides 400, so the
ragged tile is exercised. Tolerances are those of
``tests/test_torch_siren_kernel.py`` (loss rtol 1e-4, dW atol 5e-4: the JAX
kernel stashes activations and factors in bf16), and max |out| rtol 1e-6 (an
f32 forward on both sides, no bf16 stash).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.models import Siren as JSiren
from mri_super_resolution_tpu.models import SirenERD as JSirenERD
from mri_super_resolution_tpu.ops.pallas import siren_kernel as jk
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.models import Siren, SirenERD
from mri_super_resolution_tpu_torch.ops import siren_kernel as tk

torch.set_num_threads(2)

P = 400


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=(P, 2)).astype(np.float32)
    target = rng.uniform(0, 1, size=(P, 1)).astype(np.float32)
    sw = rng.uniform(0, 1, size=(P, 1)).astype(np.float32)
    sw[::7] = 0.0  # rejected pixels
    jsiren = JSiren(hidden_features=32, hidden_layers=2)
    sparams = jsiren.init(jax.random.key(0), jnp.asarray(x[:4]))
    siren = Siren(2, 32, 2)
    siren.load_state_dict(convert.siren_state_dict(_np(sparams)))
    siren.requires_grad_(False)
    jerd = JSirenERD(hidden_features=32, hidden_layers=1, perturb=True)
    eparams = jerd.init(jax.random.key(1), jnp.asarray(x[:4]), 0.0, 0.0)
    erd = SirenERD(2, 32, 1, perturb=True)
    erd.load_state_dict(convert.siren_erd_state_dict(_np(eparams)))
    erd.requires_grad_(False)
    return dict(x=x, target=target, sw=sw, jsiren=jsiren, sparams=sparams, siren=siren,
                jerd=jerd, eparams=eparams, erd=erd)


def _flax_layout(grads):
    """Port grads (out, in) -> the JAX kernel's layout (in, out) as numpy."""
    return [g.T.numpy() if g.dim() == 2 else g.numpy() for g in grads]


def _collapsed(params, weights):
    """The ERD trunk with a last bias of -10: every output is ReLU(z < 0) = 0."""
    jws = list(jk.weights_from_flax(params))
    jws[-1] = jnp.full_like(jws[-1], -10.0)
    tws = [w.clone() for w in weights]
    tws[-1] = torch.full_like(tws[-1], -10.0)
    return tuple(jws), tws


CASES = {
    # name: (model, weighted, absmax, n_rows, collapsed)
    "weighted": ("siren", True, False, None, False),
    "weighted_ragged": ("siren", True, False, P - 37, False),
    "absmax": ("erd", False, True, None, False),
    "absmax_ragged": ("erd", False, True, P - 37, False),
    "erd_weighted_absmax": ("erd", True, True, P - 5, False),
    "collapsed": ("erd", False, True, None, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_grads_variants_match_pallas(setup, case):
    kind, weighted, absmax, n_rows, collapsed = CASES[case]
    s = setup
    if kind == "siren":
        jws, tws, acts = (tuple(jk.weights_from_flax(s["sparams"])), s["siren"].weights(),
                          s["siren"].acts)
    else:
        jws, tws, acts = (tuple(jk.weights_from_flax(s["eparams"])), s["erd"].weights(),
                          s["erd"].acts)
        if collapsed:
            jws, tws = _collapsed(s["eparams"], tws)
    assert jk.acts_for_model(s["jsiren" if kind == "siren" else "jerd"]) == acts
    sw = s["sw"] if weighted else None
    outs_j = jk.siren_loss_grads(
        jnp.asarray(s["x"]), jws, jnp.asarray(s["target"]), 30.0, acts=acts, n_rows=n_rows,
        with_out_absmax=absmax, sample_weights=None if sw is None else jnp.asarray(sw))
    outs_t = tk.siren_loss_grads(
        torch.as_tensor(s["x"]), tws, torch.as_tensor(s["target"]), 30.0, n_rows=n_rows,
        acts=acts, sample_weights=None if sw is None else torch.as_tensor(sw),
        with_out_absmax=absmax)
    assert len(outs_t) == len(outs_j) == (3 if absmax else 2)
    np.testing.assert_allclose(float(outs_t[0]), float(outs_j[0]), rtol=1e-4)
    if absmax:
        np.testing.assert_allclose(float(outs_t[1]), float(outs_j[1]), rtol=1e-6)
    for gt, gj in zip(_flax_layout(outs_t[-1]), outs_j[-1]):
        np.testing.assert_allclose(gt, np.asarray(gj), atol=5e-4)
    if collapsed:
        assert float(outs_t[1]) == 0.0 == float(outs_j[1])
        assert all(float(g.abs().max()) == 0.0 for g in outs_t[-1])
        assert all(float(jnp.abs(g).max()) == 0.0 for g in outs_j[-1])


def test_weighted_zero_weights_drop_rows(setup):
    """A row of weight 0 contributes nothing: dropping it from the inputs
    (and the mean's count kept) gives the same loss and gradients."""
    s = setup
    x, t, sw = (torch.as_tensor(s[k]) for k in ("x", "target", "sw"))
    keep = sw[:, 0] > 0
    ws = s["siren"].weights()
    loss, grads = tk.siren_loss_grads(x, ws, t, sample_weights=sw, acts=s["siren"].acts)
    loss_k, grads_k = tk.siren_loss_grads(x[keep], ws, t[keep], sample_weights=sw[keep])
    n_kept = int(keep.sum())
    torch.testing.assert_close(loss, loss_k * n_kept / P, rtol=1e-5, atol=0)
    for a, b in zip(grads, grads_k):
        torch.testing.assert_close(a, b * n_kept / P, rtol=1e-4, atol=1e-7)


def test_forward_and_fused_bwd_with_relu_codes_match_pallas(setup):
    """K3 and K2 take the per-layer codes too: the SirenERD trunk forward and
    its dx / dW for an upstream g against the JAX siren_forward and the
    siren_fused backward with the same acts."""
    s = setup
    acts = s["erd"].acts
    jws = tuple(jk.weights_from_flax(s["eparams"]))
    tws = s["erd"].weights()
    x = torch.as_tensor(s["x"])
    ref = np.asarray(jk.siren_forward(jnp.asarray(s["x"]), list(jws), acts=acts))
    np.testing.assert_allclose(tk.siren_forward(x, tws, acts=acts).numpy(), ref, atol=2e-4)
    np.testing.assert_allclose(s["erd"].trunk(x).numpy(), ref, atol=2e-4)
    g = (np.random.default_rng(5).normal(size=(P, 1)) / P).astype(np.float32)
    gj = jnp.asarray(g)
    dx_j, dws_j = jax.grad(
        lambda xx, ws: jnp.sum(jk.siren_fused(xx, ws, 30.0, None, acts) * gj),
        argnums=(0, 1))(jnp.asarray(s["x"]), jws)
    dx_t, dws_t = tk.siren_fused_bwd(x, tws, torch.as_tensor(g), acts=acts)
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), atol=5e-3)
    for gt, gjw in zip(_flax_layout(dws_t), dws_j):
        np.testing.assert_allclose(gt, np.asarray(gjw), atol=5e-4)
    # the autograd Function carries the codes to its K2 backward
    xr = x.clone().requires_grad_()
    (gx,) = torch.autograd.grad(tk.siren_fused(xr, tws, 30.0, acts), xr, torch.as_tensor(g))
    torch.testing.assert_close(gx, dx_t)


def test_weighted_adapter_matches_jax_adapter(setup):
    """make_fused_weighted_value_and_grad on the port's Siren against the JAX
    adapter (which pads the 32-wide layers to 128 lanes around its kernel)."""
    s = setup
    vag_j = jk.make_fused_weighted_value_and_grad(s["jsiren"])
    loss_j, grads_j = vag_j(s["sparams"], jnp.asarray(s["x"]), jnp.asarray(s["target"]),
                            jnp.asarray(s["sw"]))
    vag_t = tk.make_fused_weighted_value_and_grad(s["siren"])
    loss_t, grads_t = vag_t(s["siren"].weights(), torch.as_tensor(s["x"]),
                            torch.as_tensor(s["target"]), torch.as_tensor(s["sw"]))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    for gt, gj in zip(_flax_layout(grads_t), jk.weights_from_flax(grads_j)):
        np.testing.assert_allclose(gt, np.asarray(gj), atol=5e-4)


def test_absmax_adapter_matches_jax_adapter(setup):
    """make_fused_value_grad_absmax on the port's SirenERD against the JAX
    adapter: loss, max |out| and the trunk's gradients (the JAX tree's
    perturbation branch gets zeros)."""
    s = setup
    vag_j = jk.make_fused_value_grad_absmax(s["jerd"])
    loss_j, am_j, grads_j = vag_j(s["eparams"], jnp.asarray(s["x"]),
                                  jnp.asarray(s["target"]))
    assert all(float(jnp.abs(v).max()) == 0
               for v in jax.tree.leaves(grads_j["params"]["perturb"]))
    vag_t = tk.make_fused_value_grad_absmax(s["erd"])
    loss_t, am_t, grads_t = vag_t(s["erd"].weights(), torch.as_tensor(s["x"]),
                                  torch.as_tensor(s["target"]))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    np.testing.assert_allclose(float(am_t), float(am_j), rtol=1e-6)
    for gt, gj in zip(_flax_layout(grads_t), jk.weights_from_flax(grads_j)):
        np.testing.assert_allclose(gt, np.asarray(gj), atol=5e-4)


def test_variants_refuse_what_the_kernels_do_not_take(setup):
    s = setup
    x, t = torch.as_tensor(s["x"]), torch.as_tensor(s["target"])
    ws = s["erd"].weights()
    with pytest.raises(ValueError):
        tk.siren_loss_grads(x, ws, t, acts=("sine",) * 4)  # a sine last layer
    with pytest.raises(ValueError):
        tk.siren_loss_grads(x, ws, t, acts=("sine", "tanh", "relu", "relu"))
    with pytest.raises(ValueError):
        tk.siren_loss_grads(x, ws, t, acts=("sine", "relu"))  # too few
    with pytest.raises(ValueError):
        tk.siren_loss_grads(x, ws, t, sample_weights=t[:-1])
    with pytest.raises(TypeError):
        tk.siren_loss_grads(x, ws, t, sample_weights=t.double())
