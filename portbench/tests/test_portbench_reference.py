"""The plain references against the port's plain CPU routes at tiny sizes:
the same inputs give the same answers, so a sound program passes and the
comparison is between the program and the published mathematics."""
import importlib

import numpy as np
import pytest
import torch

from portbench import inputs as make, plain
from portbench.configs import ens2d_siren_reference as ens_ref, sr3d_siren_reference as sr3d_ref

from mri_super_resolution_tpu_torch.core.coords import fourier_encode, mgrid
from mri_super_resolution_tpu_torch.fit.optim import Adam, StackedAdam
from mri_super_resolution_tpu_torch.models import perturbnet_apply
from mri_super_resolution_tpu_torch.ops import erd, siren_kernel

DIMS = [16, 32, 32, 1]


def _mlp(seed=3, dims=DIMS, slots=None):
    gen = make.generator(seed, "cpu")
    return gen, make.siren_weights(gen, dims, "cpu", slots=slots)


def test_siren_forward_matches_the_port():
    gen, w = _mlp()
    x = torch.rand(50, DIMS[0], generator=gen) * 2 - 1
    got = plain.siren(w, x, 30.0)
    want = siren_kernel.siren_forward_ref(x, w, 30.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_mse_loss_and_grads_match_k1():
    gen, w = _mlp()
    x = torch.rand(60, DIMS[0], generator=gen) * 2 - 1
    t = torch.rand(60, 1, generator=gen)
    loss, grads = plain.loss_and_grads(lambda p: ((plain.siren(p, x, 30.0) - t) ** 2).mean(), w)
    k_loss, k_grads = siren_kernel.siren_loss_grads(x, w, t, 30.0)
    torch.testing.assert_close(loss, k_loss.reshape(()), rtol=1e-5, atol=1e-7)
    for g, k in zip(grads, k_grads):
        torch.testing.assert_close(g, k, rtol=1e-4, atol=1e-6)


def test_weighted_loss_matches_batched_k1w():
    gen, w = _mlp(slots=3)
    x = torch.rand(40, DIMS[0], generator=gen) * 2 - 1
    t = torch.rand(3, 40, 1, generator=gen)
    sw = (torch.rand(3, 40, 1, generator=gen) > 0.2).float()
    k_loss, k_grads = siren_kernel.siren_loss_grads_batched(x, w, t, 30.0, sample_weights=sw)
    for d in range(3):
        loss, grads = plain.loss_and_grads(
            lambda p: (sw[d] * (plain.siren(p, x, 30.0) - t[d]) ** 2).mean(), [p[d] for p in w])
        torch.testing.assert_close(loss, k_loss[d], rtol=1e-5, atol=1e-7)
        for g, k in zip(grads, k_grads):
            torch.testing.assert_close(g, k[d], rtol=1e-4, atol=1e-6)


def test_adam_matches_the_ports_adam_and_stacked_adam():
    gen, w = _mlp()
    grads = [[torch.randn(p.shape, generator=gen) for p in w] for _ in range(3)]
    ours, port = plain.Adam(w, 1e-3), Adam([p.clone() for p in w], 1e-3)
    for g in grads:
        ours.step(g)
        port.step(g)
    for a, b in zip(ours.params, port.params):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
    stacked = StackedAdam([torch.stack([p, p]) for p in w], 1e-3)
    for g in grads:
        stacked.step([torch.stack([x, x]) for x in g])
    for a, b in zip(ours.params, stacked.params):
        torch.testing.assert_close(a, b[1], rtol=0, atol=1e-7)


def test_perturbnet_grid_and_fourier_match_the_port():
    gen = make.generator(5, "cpu")
    pn = make.lecun_weights(gen, [9, 8, 4], "cpu")
    x = torch.rand(30, 8, generator=gen)
    torch.testing.assert_close(plain.perturbnet(pn, x, 3, 0.5), perturbnet_apply(pn, x, 3.0, 0.5))
    assert torch.equal(plain.grid((3, 4, 5), "cpu"), mgrid((3, 4, 5)))
    B = make.fourier_matrix(gen, 6, 3, 0.5, "cpu")
    c = plain.grid((4, 4, 2), "cpu")
    torch.testing.assert_close(plain.fourier(c, B), fourier_encode(c, B))


@pytest.mark.parametrize("values", ["continuous", "ties"])
def test_complete_linkage_matches_auto_erd(values):
    rng = np.random.default_rng(11)
    if values == "continuous":
        roi = rng.random((20, 20, 27)).astype(np.float32)
        roi[..., 4] *= 0.2  # a dropout acquisition
    else:
        roi = rng.integers(0, 5, (20, 20, 27)).astype(np.float32)
    want = erd.auto_erd(torch.as_tensor(roi), None, mode=1).numpy()
    got = ens_ref.complete_linkage_mode1(roi.reshape(-1, 27)).reshape(roi.shape)
    assert np.array_equal(got, want)


def test_sr3d_prep_matches_the_pipeline():
    from mri_super_resolution_tpu_torch.data import combination_mean, expand_combinations
    from mri_super_resolution_tpu_torch.pipelines.superres3d import normalize_hybrid

    cfg = {"roi_start": 2, "roi_end": 10, "omega": 30.0}
    gen = make.generator(9, "cpu")
    patient = make.patient_3d(gen, (12, 12, 3), (1, 2, 3, 2), (0.0, 150.0, 1000.0, 1500.0), "cpu")
    B = make.fourier_matrix(gen, 8, 4, 0.5, "cpu")
    ref = sr3d_ref.prep({"patient": patient, "B": B}, cfg)
    normed, _ = normalize_hybrid([[v.numpy()] * 4 for v in patient])
    mean = combination_mean(normed, te=0).numpy()[2:10:2, 2:10:2]
    acqs = expand_combinations(*[torch.as_tensor(np.asarray(normed[b][0], np.float32)[2:10:2, 2:10:2])
                                 for b in range(4)])
    torch.testing.assert_close(ref["mean_target"], torch.as_tensor(mean.reshape(-1, 1)))
    torch.testing.assert_close(ref["acq_pixels"], acqs.reshape(-1, 12).T[..., None])
    torch.testing.assert_close(ref["ff"], fourier_encode(mgrid(mean.shape), B))


def test_references_import_nothing_of_the_program():
    for name in ("portbench.plain", "portbench.configs.sr3d_siren_reference",
                 "portbench.configs.ens2d_siren_reference"):
        source = importlib.util.find_spec(name).origin
        for line in open(source).read().splitlines():
            if line.startswith(("import ", "from ")):
                assert "mri_super_resolution_tpu" not in line and "jax" not in line, line
