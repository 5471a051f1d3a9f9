"""The port's PIA (``models/pia.py``, ``pipelines/pia_train.py``) against the
JAX package's, on the CPU.

The flax PIA's params, converted with ``convert.pia_from_flax``, go into the
port's module. Encoder, decoder and losses are compared on seeded voxels;
the training loops from the same params on the same data: ``train_synthetic``
for 10 steps on the batches the JAX loop draws from its keys (recomputed
here with the JAX package's ``synthetic_batch`` and handed to the port's
``batches``), ``finetune_on_voxels`` for 10 steps, then ``predict_maps``.

Measured gaps: maps 1.9e-7 relative, signals 2.7e-7 relative; the 10-step
loss traces 1.8e-7 relative (supervised), 1.5e-7 (noise range), 1.2e-7
(unsupervised), 3.1e-7 (fine-tune); fitted weights within 7.3e-8 of values
up to 0.58 after the fine-tune, its maps 1.9e-7 relative. Tolerances: 1e-5
relative on maps, signals and traces, 1e-6 absolute on weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.models import pia as jpia
from mri_super_resolution_tpu.pipelines import pia_train as jtrain
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.models import PIA
from mri_super_resolution_tpu_torch.models import pia as tpia
from mri_super_resolution_tpu_torch.pipelines import pia_train as ttrain

torch.set_num_threads(2)

RTOL, W_ATOL = 1e-5, 1e-6
SMALL = dict(hidden_dims=(16, 32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(params, **kw) -> PIA:
    m = PIA(**kw)
    m.load_state_dict(convert.pia_from_flax(_np(params)))
    return m


def _voxels(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1000, (n, 16)).astype(np.float32)


@pytest.mark.parametrize("kw", [{}, SMALL, dict(SMALL, predictor_depth=2)])
def test_encode_decode_match(kw):
    jm = jpia.PIA(**kw)
    x = _voxels()
    p = jm.init(jax.random.key(1), jnp.asarray(x))
    tm = _port(p, **kw)
    assert set(convert.pia_from_flax(_np(p))) == set(tm.state_dict())
    jsig, _, jD, jT, jv = jm.apply(p, jnp.asarray(x))
    with torch.no_grad():
        tsig, tx, tD, tT, tv = tm(torch.as_tensor(x))
    assert torch.equal(tx, torch.as_tensor(x))
    for t, j in ((tD, jD), (tT, jT), (tv, jv), (tsig, jsig)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tv.sum(-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(
        tpia.signal_model(tD, tT, tv).numpy(),
        np.asarray(jpia.signal_model(jD, jT, jv)), rtol=RTOL, atol=1e-4)


def test_losses_match():
    rng = np.random.default_rng(4)
    a = [rng.uniform(0.1, 2.0, s).astype(np.float32)
         for s in ((8, 16), (8, 3), (8, 3), (8, 3), (8, 16), (8, 3), (8, 3), (8, 3))]
    a[7] = a[7] / a[7].sum(-1, keepdims=True)
    pids = (rng.uniform(size=(8, 1)) > 0.3).astype(np.float32)
    j = float(jpia.pia_loss_supervised(*map(jnp.asarray, a)))
    t = float(tpia.pia_loss_supervised(*map(torch.as_tensor, a)))
    np.testing.assert_allclose(t, j, rtol=1e-6)
    j = float(jpia.pia_loss_unsupervised(jnp.asarray(a[0]), jnp.asarray(a[4]), pids))
    t = float(tpia.pia_loss_unsupervised(torch.as_tensor(a[0]), torch.as_tensor(a[4]),
                                         torch.as_tensor(pids)))
    np.testing.assert_allclose(t, j, rtol=1e-6)


def _jax_batches(key, steps, batch_size, noise_std, noise_range):
    """The batches the JAX train_synthetic draws inside its scan."""
    _, kdata = jax.random.split(key)
    out = []
    for k in jax.random.split(kdata, steps):
        sigma = noise_std
        if noise_range is not None:
            kn, k = jax.random.split(k)
            lo, hi = noise_range
            sigma = jnp.exp(jax.random.uniform(kn, (batch_size, 1), minval=jnp.log(lo),
                                               maxval=jnp.log(hi)))
        out.append(tuple(np.array(t) for t in jpia.synthetic_batch(k, batch_size, sigma)))
    return out


@pytest.mark.parametrize("supervised,noise_range", [(True, None), (True, (0.01, 0.1)),
                                                    (False, None)])
def test_train_synthetic_trace_matches(supervised, noise_range):
    key, steps, bs = jax.random.key(7), 10, 32
    jm = jpia.PIA(**SMALL)
    jres = jtrain.train_synthetic(jm, key, steps=steps, batch_size=bs, lr=1e-3,
                                  supervised=supervised, noise_range=noise_range)
    kinit, _ = jax.random.split(key)
    sample, *_ = jpia.synthetic_batch(kinit, bs, 0.1)
    tm = _port(jm.init(kinit, sample), **SMALL)
    batches = _jax_batches(key, steps, bs, 0.1, noise_range)
    tres = ttrain.train_synthetic(tm, torch.Generator(), steps=steps, batch_size=bs,
                                  lr=1e-3, supervised=supervised, batches=batches)
    assert tres.model is tm and tres.losses.shape == (steps,)
    np.testing.assert_allclose(tres.losses.numpy(), np.asarray(jres.losses), rtol=RTOL)


def test_finetune_and_predict_maps_match():
    jm = jpia.PIA(**SMALL)
    x = _voxels(50, seed=5)
    pids = (np.random.default_rng(6).uniform(size=(50, 1)) > 0.2).astype(np.float32)
    p = jm.init(jax.random.key(2), jnp.asarray(x))
    tm = _port(p, **SMALL)
    jres = jtrain.finetune_on_voxels(jm, p, jnp.asarray(x), jnp.asarray(pids), steps=10,
                                     lr=1e-3)
    tres = ttrain.finetune_on_voxels(tm, torch.as_tensor(x), torch.as_tensor(pids),
                                     steps=10, lr=1e-3)
    np.testing.assert_allclose(tres.losses.numpy(), np.asarray(jres.losses), rtol=RTOL)
    want = convert.pia_from_flax(_np(jres.params))
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=W_ATOL, err_msg=k)
    jmaps = jtrain.predict_maps(jm, jres.params, jnp.asarray(x), batch=16)
    tmaps = ttrain.predict_maps(tm, torch.as_tensor(x), batch=16)
    for t, j in zip(tmaps, jmaps):
        assert t.shape == (50, 3)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=1e-6)


def test_synthetic_batch_from_a_generator():
    g = torch.Generator().manual_seed(0)
    sig, D, T2, v, clean = tpia.synthetic_batch(g, 64, 0.05)
    assert sig.shape == clean.shape == (64, 16) and D.shape == T2.shape == v.shape == (64, 3)
    assert (D[:, 0] >= 0.3).all() and (D[:, 0] <= 0.7).all()
    assert (T2[:, 2] >= 500).all() and (T2[:, 2] <= 1000).all()
    np.testing.assert_allclose(v.sum(-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(clean.numpy(), tpia.signal_model(D, T2, v).numpy())
    again = tpia.synthetic_batch(torch.Generator().manual_seed(0), 64, 0.05)
    assert torch.equal(again[0], sig)
    # per-voxel sigmas: a zero sigma leaves that voxel clean
    sigma = torch.zeros(8, 1)
    sigma[0] = 0.1
    s2, *_, c2 = tpia.synthetic_batch(g, 8, sigma)
    assert torch.equal(s2[1:], c2[1:]) and not torch.equal(s2[0], c2[0])
