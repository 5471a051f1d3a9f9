"""The port's half-res quality protocol (superres-lowres.ipynb) against the
JAX package's: the anti-aliased downscaling ``rescale``, ``psnr``, then
``run_slice`` in both protocols from the JAX init, ``run``'s CSV and the
``superres_lowres`` CLI on the CPU.

Gaps read on the CPU before the bars were set: ``rescale(., 0.5,
anti_aliasing=True)`` 1.8e-7 at most over even and odd sizes (a plain
2-tap bilinear resize would part by 0.2-0.4: ``jax.image.resize`` spreads
its triangle kernel over 1/scale pixels, as ``antialias=True`` does), so
1e-6; ``psnr`` float32 rounding, rtol 1e-6. ``run_slice`` on the 24 x 24
structured case (hidden 48, 2 layers, 5 phase-2 steps): phase 1 is the
port's plain K1-a against the JAX package's autodiff (off the TPU it has
no kernel), float32 in another order, so the threshold sits where the JAX
trace drops by 1% below every earlier step and both stop at the same step;
then LR and spline 1.2e-7 (bar 1e-6), SR 7.7e-7 (bar 1e-5, the soft-ERD
test's recon bar), masked SSIM 4.8e-7 (bar 1e-5) and PSNR 1.9e-6 dB
(bar rtol 1e-5).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.io as sio
import torch

from mri_super_resolution_tpu.core import interp as jinterp
from mri_super_resolution_tpu.core import metrics as jmetrics
from mri_super_resolution_tpu.core.coords import mgrid as jmgrid
from mri_super_resolution_tpu.fit.engine import plain_apply_init as j_plain_apply_init
from mri_super_resolution_tpu.models import SirenERD as JSirenERD
from mri_super_resolution_tpu.pipelines import inr_erd as jie
from mri_super_resolution_tpu.pipelines import lowres_qual as jlq
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.cli import superres_lowres as lowres_cli
from mri_super_resolution_tpu_torch.core import interp as tinterp
from mri_super_resolution_tpu_torch.core import metrics as tmetrics
from mri_super_resolution_tpu_torch.ops import siren_kernel as sk
from mri_super_resolution_tpu_torch.pipelines import inr_erd, lowres_qual

torch.set_num_threads(2)

HIDDEN, LAYERS, SLICE, SEED = 48, 2, 1, 0


@pytest.mark.parametrize("shape", [(24, 24), (25, 25), (13, 8), (9, 14)])
def test_rescale_downscale_matches_jax(shape):
    img = np.random.default_rng(sum(shape)).uniform(0, 1, size=shape).astype(np.float32)
    ref = np.asarray(jinterp.rescale(jnp.asarray(img), 0.5, anti_aliasing=True))
    got = tinterp.rescale(torch.as_tensor(img), 0.5, anti_aliasing=True).numpy()
    assert got.shape == ref.shape == (shape[0] // 2, shape[1] // 2)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    # batched over a leading axis, image by image the same
    stack = tinterp.rescale(torch.as_tensor(np.stack([img, 2 * img])), 0.5, anti_aliasing=True)
    np.testing.assert_allclose(stack[1].numpy(), 2 * got, atol=1e-6)


@pytest.mark.parametrize("shape", [(12, 12), (7, 5)])
def test_rescale_upscale_unchanged(shape):
    img = np.random.default_rng(5).uniform(0, 1, size=shape).astype(np.float32)
    ref = np.asarray(jinterp.rescale(jnp.asarray(img), 2, anti_aliasing=True))
    got = tinterp.rescale(torch.as_tensor(img), 2, anti_aliasing=True).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_psnr_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, size=(20, 18)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, size=a.shape), 0, None).astype(np.float32)
    for data_range in (1.0, 2.0):
        want = float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b), data_range=data_range))
        got = float(tmetrics.psnr(torch.as_tensor(a), torch.as_tensor(b), data_range))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _structured_case(rng):
    """tests/test_lowres_qual.py's structured case (24 x 24 x 3, four
    acquisitions), as both packages' ERDCase."""
    H = W = 24
    S, A = 3, 4
    y, x = np.mgrid[0:H, 0:W] / H
    base = 0.5 + 0.3 * np.sin(4 * np.pi * x) * np.cos(3 * np.pi * y) + 0.15 * y
    b0 = np.repeat(base[:, :, None], S, axis=2).astype(np.float32) * 2.0
    b3 = np.stack([b0 * 0.5 + 0.002 * rng.normal(size=(H, W, S)).astype(np.float32)
                   for _ in range(A)], axis=-1).astype(np.float32)
    kw = dict(pt_id="18-1681-77", b=(0.0, 150.0, 1000.0, 1500.0), cancer_loc=(12, 12),
              contralateral_loc=(8, 8), noise=(18, 18), cancer_slice=SLICE, b0=b0, b3=b3)
    return jie.ERDCase(**kw), inr_erd.ERDCase(**kw)


def _threshold(jmodel, p0, case, split: bool) -> float:
    """A phase-1 threshold where the JAX loss trace on the case's LR target
    drops 1% below every earlier step (between steps 120 and 200)."""
    dwi = case.b3[:, :, SLICE, :]
    half = dwi.shape[-1] // 2
    gt, mean = (dwi[..., half:].mean(-1), dwi[..., :half].mean(-1)) if split else \
        (dwi.mean(-1), dwi.mean(-1))
    lr = jinterp.rescale(jnp.asarray(mean / (float(gt.max()) + 1e-12)), 0.5,
                         anti_aliasing=True)
    coords, target = jmgrid(lr.shape), lr.reshape(-1, 1)
    apply_fn, _ = j_plain_apply_init(jmodel)
    tx = optax.adam(lowres_qual.LowresQualConfig.pretrain_lr)
    state, params = tx.init(p0), p0
    vg = jax.jit(jax.value_and_grad(lambda p: jnp.mean((apply_fn(p, coords) - target) ** 2)))
    trace = []
    for _ in range(200):
        loss, g = vg(params)
        upd, state = tx.update(g, state)
        params = optax.apply_updates(params, upd)
        trace.append(float(loss))
    trace = np.asarray(trace)
    k = next(i for i in range(120, 200) if trace[i] < 0.99 * trace[:i].min())
    return float(trace[k]) * 1.001


def _inject_init(monkeypatch, params):
    """The port's phase 1 starts from the JAX init (converted); a restart
    would ask for a second init and fail."""
    real = lowres_qual.plain_apply_init

    def plain_apply_init(model, generator=None):
        apply_fn, _ = real(model, generator)

        def init_fn(k):
            assert k == 0, "phase 1 restarted"
            model.load_state_dict(convert.siren_erd_state_dict(jax.tree.map(np.asarray,
                                                                            params)))
            return model.weights()

        return apply_fn, init_fn

    monkeypatch.setattr(lowres_qual, "plain_apply_init", plain_apply_init)


@pytest.mark.parametrize("split", [False, True])
def test_run_slice_matches_jax(monkeypatch, split):
    jcase, tcase = _structured_case(np.random.default_rng(0))
    jmodel = JSirenERD(hidden_features=HIDDEN, hidden_layers=LAYERS, perturb=True)
    _, sub = jax.random.split(jax.random.key(SEED))  # fit_until's first init key
    p0 = jmodel.init(sub, jnp.zeros((1, 2)), 0.0, 0.0)
    kw = dict(hidden_features=HIDDEN, hidden_layers=LAYERS,
              loss_threshold=_threshold(jmodel, p0, jcase, split), phase2_steps=5,
              max_pretrain_steps=8000, split_protocol=split)
    want = jlq.run_slice(jcase, SLICE, jlq.LowresQualConfig(**kw), seed=SEED)
    _inject_init(monkeypatch, p0)
    sk.reset_launches()
    got = lowres_qual.run_slice(tcase, SLICE, lowres_qual.LowresQualConfig(**kw), seed=SEED,
                                device="cpu")
    assert not any(sk.LAUNCHES.values())
    assert got.pretrain_steps == int(want.pretrain_steps) > 120
    np.testing.assert_array_equal(got.gt, want.gt)
    for name, atol in (("lr", 1e-6), ("spline", 1e-6), ("sr", 1e-5)):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=atol, err_msg=name)
    np.testing.assert_allclose(got.metrics[:2], want.metrics[:2], atol=1e-5)
    np.testing.assert_allclose(got.metrics[2:], want.metrics[2:], rtol=1e-5)
    assert got.sr.shape == (24, 24) and got.lr.shape == (12, 12)


def test_run_writes_the_csv(tmp_path):
    _, case = _structured_case(np.random.default_rng(1))
    cfg = lowres_qual.LowresQualConfig(hidden_features=16, hidden_layers=1,
                                       loss_threshold=1e-2, phase2_steps=2)
    path = lowres_qual.run([case], cfg, str(tmp_path / "lq.csv"), slices=[0, 2, 7],
                           device="cpu")
    lines = open(path).read().splitlines()
    assert lines[0] == ",".join(lowres_qual.LOWRES_QUAL_HEADER)
    assert [ln.split(",")[:2] for ln in lines[1:]] == [["18-1681-77", "0"],
                                                       ["18-1681-77", "2"]]  # 7 skipped
    for ln in lines[1:]:
        vals = [float(v) for v in ln.split(",")[2:]]
        assert all(np.isfinite(vals))
        # SSIM rounded to 5 places, PSNR to 3
        assert all(len(v.split(".")[1]) <= d for v, d in zip(ln.split(",")[2:], (5, 5, 3, 3)))


def _write_volume(data_dir, seed):
    """A (100, 100, 12) mean-b0 volume as pat07_mean_b0.mat (the registry's
    noise ROI fits)."""
    rng = np.random.default_rng(seed)
    os.makedirs(data_dir, exist_ok=True)
    yy, xx = np.mgrid[0:100, 0:100] / 99.0
    blob = 40 + 200 * np.exp(-((xx - 0.6) ** 2 + (yy - 0.7) ** 2) / 0.05)
    vol = (blob[..., None] * np.ones(12) + rng.uniform(0, 5, (100, 100, 12))).astype(np.float32)
    sio.savemat(os.path.join(data_dir, "pat07_mean_b0.mat"), {"data_mean_b0": vol})


@pytest.mark.parametrize("mode", [["--cancer_slice_only"], ["--slices", "3",
                                                             "--split_protocol"]])
def test_superres_lowres_cli_on_cpu(tmp_path, mode):
    data = str(tmp_path / "data")
    _write_volume(data, seed=2)
    sk.reset_launches()
    path = lowres_cli.main([
        "--limit_cases", "1", "--num_acq", "4", "--phase2_steps", "2", "--loss_threshold",
        "1e-2", "--out_csv", str(tmp_path / "out.csv"), "--data_dir", data,
        "--device", "cpu", *mode])
    assert not any(sk.LAUNCHES.values())
    lines = open(path).read().splitlines()
    assert lines[0] == ",".join(lowres_qual.LOWRES_QUAL_HEADER) and len(lines) == 2
    assert lines[1].split(",")[:2] == ["18-1681-07", "11" if len(mode) == 1 else "3"]
    assert all(np.isfinite(float(v)) for v in lines[1].split(",")[2:])


def test_run_slice_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, case = _structured_case(np.random.default_rng(1))
    with pytest.raises(RuntimeError, match="cuda"):
        lowres_qual.run_slice(case, SLICE, lowres_qual.LowresQualConfig())
