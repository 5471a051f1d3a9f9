"""The port's Siren and PerturbNet against the flax models, through the
converter (flax kernel (in, out) -> torch weight (out, in))."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.models import PerturbNet as JPerturbNet
from mri_super_resolution_tpu.models import Siren as JSiren
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.models import PerturbNet, Siren

torch.set_num_threads(2)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("hidden,layers", [(64, 2), (32, 1)])
def test_siren_forward_matches_flax(hidden, layers):
    x = np.random.default_rng(0).uniform(-1, 1, size=(200, 24)).astype(np.float32)
    jm = JSiren(hidden_features=hidden, hidden_layers=layers)
    params = jm.init(jax.random.key(1), jnp.asarray(x))
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = Siren(24, hidden, layers)
    tm.load_state_dict(convert.siren_state_dict(_np_tree(params)))
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4)
    # the kernels' flat weight list is the module's parameters in order
    flat = convert.siren_weights(_np_tree(params))
    for a, b in zip(flat, tm.weights()):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("sample,eps", [(0.0, 0.0), (3.0, 1.0 / 128.0), (74.0, 0.5)])
def test_perturbnet_forward_matches_flax(sample, eps):
    x = np.random.default_rng(2).uniform(-1, 1, size=(150, 32)).astype(np.float32)
    jm = JPerturbNet(hidden_features=16, dimension=4)
    params = jm.init(jax.random.key(3), jnp.asarray(x), 0, 0.0)
    ref = np.asarray(jm.apply(params, jnp.asarray(x), sample, eps))
    tm = PerturbNet(32, hidden_features=16, dimension=4)
    tm.load_state_dict(convert.perturbnet_state_dict(_np_tree(params)))
    with torch.no_grad():
        got = tm(torch.as_tensor(x), sample, eps).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4)


def test_siren_init_bounds_and_seed():
    """SIREN init: first W in U(+-1/in), hidden/final W in U(+-sqrt(6/in)/30),
    biases in U(+-1/sqrt(in)); one seed gives one model."""
    a = Siren(20, 64, 2, generator=torch.Generator().manual_seed(5))
    b = Siren(20, 64, 2, generator=torch.Generator().manual_seed(5))
    for pa, pb in zip(a.weights(), b.weights()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    ws = [w.detach() for w in a.weights()]
    assert float(ws[0].abs().max()) <= 1.0 / 20
    assert float(ws[0].abs().max()) > 0.9 / 20
    for W in ws[2::2]:
        bound = np.sqrt(6.0 / 64) / 30.0
        assert bound * 0.9 < float(W.abs().max()) <= bound
    assert float(ws[1].abs().max()) <= 1.0 / np.sqrt(20)


def test_perturbnet_init_is_lecun_normal():
    pn = PerturbNet(256, 128, 4, generator=torch.Generator().manual_seed(0))
    w = pn.fc0.weight.detach()
    std = np.sqrt(1.0 / 257)
    assert abs(float(w.std()) - std) < 0.05 * std
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
