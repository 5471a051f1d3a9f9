"""The port's WIRE model, converter and kernels K4-K5 against the JAX
package: the flax ``Wire`` (its forward and ``jax.value_and_grad``) and the
Pallas ``wire_forward`` / ``wire_loss_grads`` in interpret mode, as
``tests/test_wire_kernel.py`` runs them.

On CPU tensors the port's wrappers run their plain PyTorch versions (the CUDA
kernels run only on the card: ``tests/test_torch_cuda.py``,
``chip_smoke.py``). Inputs are raw 4-D coordinates from a numpy seed; the
JAX-drawn initial params reach the port through ``convert.py``.

Measured gaps (300 rows, 4 -> 64x2 / 32x1 / 128x2 -> 1, float32 on both
sides): module vs flax forward 3.7e-7 (tol atol 2e-5, the JAX package's own
forward tolerance); plain K4 vs flax autodiff: loss 1.5e-7 relative (tol
rtol 1e-6), each gradient within 1.9e-6 of its largest entry (tol 1e-5 of
it); plain K5 vs the Pallas forward 4.2e-7 (tol atol 2e-5); plain K4 vs the
Pallas kernel: loss 7.9e-8 relative (tol rtol 1e-5), gradients 0.69% of each
leaf's largest entry (tol 2%, the JAX package's own: its kernel stashes bf16
and uses polynomial trig).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.models import Wire as JWire
from mri_super_resolution_tpu.ops.pallas import wire_kernel as jwk
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.models import Wire, wire_apply
from mri_super_resolution_tpu_torch.ops import wire_kernel as wk

torch.set_num_threads(2)

CONFIGS = [(64, 2), (32, 1)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=CONFIGS, ids=lambda c: f"{c[0]}x{c[1]}")
def setup(request):
    hidden, layers = request.param
    rng = np.random.default_rng(hidden)
    x = rng.uniform(-1, 1, size=(300, 4)).astype(np.float32)
    target = rng.uniform(0, 1, size=(300, 1)).astype(np.float32)
    jm = JWire(hidden_features=hidden, hidden_layers=layers)
    params = jm.init(jax.random.key(1), jnp.asarray(x))
    tm = Wire(4, hidden, layers)
    tm.load_state_dict(convert.wire_state_dict(_np(params)))
    tm.requires_grad_(False)
    ws, oms = convert.wire_weights(_np(params))
    return dict(jm=jm, params=params, tm=tm, x=x, target=target, ws=ws, oms=oms,
                layers=layers)


def _leaf_close(got, want, frac, what=""):
    """Each gradient within ``frac`` of its largest entry."""
    for i, (a, b) in enumerate(zip(got, want)):
        b = torch.as_tensor(np.array(b))
        scale = float(b.abs().max()) + 1e-12
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=frac * scale,
                                   err_msg=f"{what} gradient {i}")


def _flax_layout(grads):
    """Port gradients (out, in) -> the JAX kernel's (in, out), as numpy."""
    return [g.T.numpy() if g.dim() == 2 else g.numpy() for g in grads]


def test_forward_matches_flax(setup):
    ref = np.asarray(setup["jm"].apply(setup["params"], jnp.asarray(setup["x"])))
    x = torch.as_tensor(setup["x"])
    with torch.no_grad():
        got = setup["tm"](x).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    # the plain K5 (single-exponential form) and the wrapper on the CPU
    plain = wk.wire_forward(x, setup["ws"], setup["oms"]).numpy()
    np.testing.assert_allclose(plain, ref, atol=2e-5)


def test_converter_matches_the_jax_flattening(setup):
    """wire_weights == wire_weights_from_flax (transposed to (out, in)), and
    the state dict loads strictly, the final layer's unused bias_i too."""
    jws, joms = jwk.wire_weights_from_flax(setup["params"], setup["layers"])
    assert len(setup["ws"]) == len(jws) == 4 + 8 * setup["layers"] + 3
    for a, b in zip(_flax_layout(setup["ws"]), jws):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(setup["oms"].numpy(), np.asarray(joms))
    sd = convert.wire_state_dict(_np(setup["params"]))
    assert "final.bias_i" in sd
    Wire(4, setup["tm"].final.weight_r.shape[1], setup["layers"]).load_state_dict(sd)
    for a, b in zip(setup["tm"].weights(), setup["ws"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("n_rows", [None, 250])
def test_loss_grads_ref_matches_flax_autodiff(setup, n_rows):
    n = 300 if n_rows is None else n_rows
    jm, params = setup["jm"], setup["params"]
    xj, tj = jnp.asarray(setup["x"][:n]), jnp.asarray(setup["target"][:n])
    loss_j, g_j = jax.value_and_grad(lambda p: jnp.mean((jm.apply(p, xj) - tj) ** 2))(params)
    loss_t, g_t = wk.wire_loss_grads(torch.as_tensor(setup["x"]), setup["ws"], setup["oms"],
                                     torch.as_tensor(setup["target"]), n_rows=n_rows)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    g_flat, g_oms = convert.wire_weights(_np(g_j))
    assert float(g_oms.abs().max()) == 0.0  # trainable=False: stop_gradient
    _leaf_close(g_t, g_flat, 1e-5, "flax autodiff")


def test_matches_pallas_interpret(setup):
    x, t, nh = jnp.asarray(setup["x"]), jnp.asarray(setup["target"]), setup["layers"]
    jws, joms = jwk.wire_weights_from_flax(setup["params"], nh)
    out_j = np.asarray(jwk.wire_forward(x, tuple(jws), joms, nh))
    out_t = wk.wire_forward_ref(torch.as_tensor(setup["x"]), setup["ws"], setup["oms"])
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=2e-5)
    loss_j, dws_j = jwk.wire_loss_grads(x, tuple(jws), joms, t, nh)
    loss_t, dws_t = wk.wire_loss_grads_ref(torch.as_tensor(setup["x"]), setup["ws"],
                                           setup["oms"], torch.as_tensor(setup["target"]))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    dws_t = [torch.as_tensor(g) for g in _flax_layout(dws_t)]
    _leaf_close(dws_t, dws_j, 0.02, "Pallas interpret")


def test_row_mask_equals_fewer_rows(setup):
    """Rows at and beyond n_rows contribute nothing, whatever their target."""
    x, t = torch.as_tensor(setup["x"]), torch.as_tensor(setup["target"])
    t_bad = t.clone()
    t_bad[250:] = 1e6
    loss_m, g_m = wk.wire_loss_grads(x, setup["ws"], setup["oms"], t_bad, n_rows=250)
    loss_s, g_s = wk.wire_loss_grads(x[:250].contiguous(), setup["ws"], setup["oms"],
                                     t[:250].contiguous())
    torch.testing.assert_close(loss_m, loss_s, rtol=1e-6, atol=0)
    for a, b in zip(g_m, g_s):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-8)


def test_scales_are_read_and_trainable_gates_their_gradient(setup):
    """omega/sigma are always read from the params (a trained value changes
    the output with trainable=False too); trainable only lets gradients into
    them, and then they equal flax's."""
    nh = setup["layers"]
    x = torch.as_tensor(setup["x"])
    params = [p.detach().clone() for p in setup["tm"].params()]
    base = wire_apply(params, x, nh)
    moved = [p.clone() for p in params]
    moved[-2] += 0.5  # the last layer's omega_0
    assert not torch.allclose(wire_apply(moved, x, nh), base)
    omegas = wk.split_params(moved, nh)[2]
    torch.testing.assert_close(wk.wire_forward(x, setup["ws"], omegas),
                               wire_apply(moved, x, nh), rtol=1e-5, atol=2e-6)

    t = torch.as_tensor(setup["target"])
    leaves = [p.clone().requires_grad_() for p in params]
    loss = torch.mean((wire_apply(leaves, x, nh, trainable=False) - t) ** 2)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert all(g is None for g in grads[-2 * (nh + 1):])

    jm = JWire(hidden_features=setup["tm"].final.weight_r.shape[1], hidden_layers=nh,
               trainable=True)
    xj, tj = jnp.asarray(setup["x"]), jnp.asarray(setup["target"])
    _, g_j = jax.value_and_grad(lambda p: jnp.mean((jm.apply(p, xj) - tj) ** 2))(
        setup["params"])
    loss = torch.mean((wire_apply(leaves, x, nh, trainable=True) - t) ** 2)
    grads = torch.autograd.grad(loss, leaves)
    g_flat, g_oms = convert.wire_weights(_np(g_j))
    _leaf_close(grads[:len(g_flat)], g_flat, 1e-5, "trainable weights")
    got_oms = torch.stack(grads[len(g_flat):]).view(nh + 1, 2)
    torch.testing.assert_close(got_oms, g_oms, rtol=1e-4, atol=1e-9)


def test_engine_adapters(setup):
    """make_wire_value_and_grad: K4 for the weights, zeros for omega/sigma;
    make_wire_fused_apply: K5 reading omega/sigma from the params."""
    nh = setup["layers"]
    params = setup["tm"].params()
    x, t = torch.as_tensor(setup["x"]), torch.as_tensor(setup["target"])
    loss, grads = wk.make_wire_value_and_grad(nh)(params, x, t)
    loss_r, grads_r = wk.wire_loss_grads_ref(x, setup["ws"], setup["oms"], t)
    assert len(grads) == len(params)
    torch.testing.assert_close(loss, loss_r, rtol=0, atol=0)
    for a, b in zip(grads, grads_r):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for g in grads[len(grads_r):]:
        assert g.shape == (1,) and float(g) == 0.0
    with torch.no_grad():
        torch.testing.assert_close(wk.make_wire_fused_apply(nh)(params, x),
                                   setup["tm"](x), rtol=1e-5, atol=2e-6)


def test_cpu_runs_plain_versions_without_launching(setup):
    wk.reset_launches()
    x, t = torch.as_tensor(setup["x"]), torch.as_tensor(setup["target"])
    wk.wire_forward(x, setup["ws"], setup["oms"])
    wk.wire_loss_grads(x, setup["ws"], setup["oms"], t)
    assert wk.LAUNCHES == {"wire_forward": 0, "wire_loss_grads": 0, "wire_loss_grads_tc": 0,
                           "wire_forward_tc": 0}


@pytest.mark.parametrize("H,n_hidden,route", [
    (256, 2, True),  # the reference's WIRE (config.py wire_hidden, wire_layers)
    (512, 2, True), (64, 1, True), (128, 3, True),
    (100, 2, False), (96, 2, False), (32, 2, False),  # 2H or 4H off the 128 tile
    (256, 0, False),  # no hidden layer: no block products
])
def test_wire_tc_route_rule(H, n_hidden, route):
    """K4's tensor-core route is chosen from the shapes alone."""
    assert wk.wire_tc_route(H, n_hidden) is route


def test_k5_wrapper_sends_a_full_width_card_call_to_the_tc_key(monkeypatch):
    """The wrapper's dispatch for a CUDA tensor (the launches stubbed out,
    this machine has no card): K5 at the WIRE path's 4 -> 256x2 -> 1 goes to
    the tensor-core forward and counts under ``wire_forward_tc``; a width
    off the route keeps the SIMT forward and its key."""
    calls = []
    monkeypatch.setattr(wk, "_check", lambda *a: "cuda")
    monkeypatch.setattr(wk, "_tc_lib", lambda: "tc-lib")
    monkeypatch.setattr(wk, "_lib", lambda: "simt-lib")
    monkeypatch.setattr(wk._build, "stream_ptr", lambda: 0)
    monkeypatch.setattr(wk, "_launch_forward_tc", lambda lib, *a: calls.append(lib) or "tc")
    monkeypatch.setattr(wk, "_launch_forward", lambda lib, *a: calls.append(lib) or "simt")
    wk.reset_launches()
    for H, want in ((256, "tc"), (96, "simt")):
        model = Wire(4, H, 2)
        ws, _, oms = wk.split_params(model.params(), 2)
        assert wk.wire_forward(torch.zeros(10, 4), ws, oms) == want
    assert calls == ["tc-lib", "simt-lib"]
    assert wk.LAUNCHES == {"wire_forward": 1, "wire_loss_grads": 0, "wire_loss_grads_tc": 0,
                           "wire_forward_tc": 1}
    wk.reset_launches()


def test_wrappers_refuse_what_the_kernels_do_not_take(setup):
    ws, oms = setup["ws"], setup["oms"]
    x, t = torch.as_tensor(setup["x"]), torch.as_tensor(setup["target"])
    with pytest.raises(TypeError):
        wk.wire_forward(x.double(), ws, oms)
    with pytest.raises(ValueError):
        wk.wire_forward(x[:, :3].contiguous(), ws, oms)  # d_in does not match W
    with pytest.raises(ValueError):
        wk.wire_forward(x.t().contiguous().t(), ws, oms)  # non-contiguous
    with pytest.raises(ValueError):
        wk.wire_forward(x, ws[:-1], oms)  # not 4 + 8 n + 3 weights
    with pytest.raises(ValueError):
        wk.wire_forward(x, ws, oms[:-1].contiguous())  # one (omega, sigma) short
    with pytest.raises(ValueError):
        wk.wire_loss_grads(x, ws, oms, t, n_rows=0)
    with pytest.raises(ValueError):
        wk.wire_loss_grads(x, ws, oms, t[:-1])
    with pytest.raises(ValueError):
        wk.wire_forward(x.to("meta"), [w.to("meta") for w in ws], oms.to("meta"))


def test_init_bounds_and_seed():
    """First-layer W in U(+-1/in), complex weights lecun-normal, biases in
    U(+-1/sqrt(in)), omega/sigma at their constants; one seed, one model."""
    a = Wire(4, 64, 2, omega_0=7.0, sigma_0=3.0,
             generator=torch.Generator().manual_seed(3))
    b = Wire(4, 64, 2, omega_0=7.0, sigma_0=3.0,
             generator=torch.Generator().manual_seed(3))
    for pa, pb in zip(a.params(), b.params()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    w = [p.detach() for p in a.weights()]
    assert 0.9 / 4 < float(w[0].abs().max()) <= 1.0 / 4
    assert float(w[1].abs().max()) <= 0.5
    kr = torch.cat([w[4].flatten(), w[5].flatten(), w[12].flatten()])
    assert abs(float(kr.std()) - np.sqrt(1 / 64)) < 0.05 * np.sqrt(1 / 64)
    assert [float(s.detach()) for s in a.scales()] == [7.0, 3.0] * 3
