"""The port's RAMS serving path against the benchmark's plain float32
reference (``portbench/configs/rams_misr_reference.py``, loaded by path;
it imports neither the port nor JAX), on the CPU at a small size: seeded
flax-named weights (``portbench/entries/predict_case.py:seeded_params``)
reach the port through ``convert.rams_state_dict`` and the reference
through its own name mapping, so the two mappings are held to each other
too.

Measured gaps (the largest absolute difference over the reference output's
largest magnitude, float32): 5.3e-7 at (2, 16, 16, 9), filters 8, N 2, r 4,
either conv route; the committed checkpoint at 12 x 12, 9.0e-7. In
bfloat16 the gap over the output's range is 4.7e-3 (library route) and
4.6e-3 (K6's plain route), 1.2 x 2^-8.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.config import RAMSConfig
from mri_super_resolution_tpu_torch.data import Case
from mri_super_resolution_tpu_torch.ops import conv3d_kernel
from mri_super_resolution_tpu_torch.pipelines import misr
from mri_super_resolution_tpu_torch.utils import profiling
from portbench.entries.predict_case import seeded_params

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(scale=3, filters=8, kernel_size=3, channels=9, r=4, N=2)
# float32: the port and the reference differ in the order of their sums
# (channels-last taps against cuDNN/MKL-DNN's channels-first conv), 5e-7 seen
F32_REL = 1e-5
# bfloat16 keeps 8 significant bits: neighbouring values part by 2^-8 of
# their size, and the port rounds every activation of the ~30 layers on the
# way to the output (the reference none); measured 1.2 x 2^-8 of the
# output's range, bound 4 x 2^-8
BF16_OF_RANGE = 4 * 2.0 ** -8


def _reference():
    path = os.path.join(REPO, "portbench", "configs", "rams_misr_reference.py")
    spec = importlib.util.spec_from_file_location("rams_misr_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _reference()


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, arr in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def _port(flat: dict, **cfg) -> torch.nn.Module:
    return misr.load_model(RAMSConfig(**cfg), convert.rams_state_dict(_nest(flat)), "cpu")


def _acquisitions(shape, seed=0) -> np.ndarray:
    """Draws in the checkpoint's working range of the uint16 scale."""
    return (np.random.default_rng(seed).random(shape) * 20000 + 2000).astype(np.float32)


def _forwards(flat, x, **cfg):
    with torch.inference_mode():
        got = _port(flat, **cfg)(torch.as_tensor(x))[..., 0].numpy()
    want = REF.forward(REF.network(flat, "cpu"), torch.as_tensor(x), cfg.get("scale", 3)).numpy()
    return got.astype(np.float64), want.astype(np.float64)


@pytest.mark.parametrize("conv_kernel", [False, True])
def test_port_matches_plain_reference_in_float32(conv_kernel):
    flat = seeded_params(SMALL, 5)
    got, want = _forwards(flat, _acquisitions((2, 16, 16, 9)), **SMALL,
                          compute_dtype="float32", conv_kernel=conv_kernel)
    assert got.shape == want.shape == (2, 48, 48)
    assert np.abs(got - want).max() <= F32_REL * np.abs(want).max()


@pytest.mark.parametrize("conv_kernel", [False, True])
def test_port_in_bfloat16_within_bf16s_step_of_the_reference(conv_kernel):
    flat = seeded_params(SMALL, 6)
    got, want = _forwards(flat, _acquisitions((2, 16, 16, 9), 1), **SMALL,
                          compute_dtype="bfloat16", conv_kernel=conv_kernel)
    gap = np.abs(got - want).max() / (want.max() - want.min())
    assert gap <= BF16_OF_RANGE
    assert gap > 2.0 ** -14  # the port did compute in bfloat16


def test_committed_checkpoint_through_both_name_mappings():
    with np.load(convert.RAMS_PARAMS_NPZ, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    got, want = _forwards(flat, _acquisitions((1, 12, 12, 9), 2), compute_dtype="float32")
    assert got.shape == (1, 36, 36)
    assert np.abs(got - want).max() <= F32_REL * np.abs(want).max()


def _case(seed=3, side=12, n_acq=27, b=900.0) -> Case:
    rng = np.random.default_rng(seed)
    dwi = (rng.random((side, side, 1, n_acq)) * 60 + 20).astype(np.float32)
    b0 = (rng.random((side, side, 1)) * 100 + 150).astype(np.float32)
    return Case(pt_id="t-0", b=b, cancer_loc=(0, 0), contralateral_loc=(0, 0), noise=(0, 0),
                cancer_slice=0, acquisitions=(9, 9, 9), dwi=dwi, b0=b0,
                erd=np.zeros_like(b0), accept=np.ones(dwi.shape, dtype=np.int32))


def test_predict_case_matches_the_references_draws_mean_and_adc():
    flat = seeded_params(SMALL, 7)
    cfg = RAMSConfig(**SMALL, compute_dtype="float32")
    case, seed, draws = _case(), 12345, 4
    with torch.inference_mode():
        dwi, adc = misr.predict_case(_port(flat, **SMALL, compute_dtype="float32"), case, cfg,
                                     draws, seed, "cpu")
    want_dwi, want_adc = REF.predict_case(REF.network(flat, "cpu"), case.dwi[:, :, 0],
                                          case.b0[:, :, 0], case.b, seed, 9, draws, 3, "cpu")
    assert dwi.shape == adc.shape == (36, 36)
    # both are means of rounded draws: a draw whose output lies within the
    # float32 sums' gap of a half rounds the other way and moves its voxel
    # by 1 / draws (16 of 1,296 voxels here)
    same = dwi == want_dwi
    assert same.mean() > 0.95
    np.testing.assert_allclose(dwi, want_dwi, rtol=0, atol=1.0 / draws + 1e-3)
    lit = same & (want_dwi > 0)
    assert lit.mean() > 0.5
    np.testing.assert_allclose(adc[lit], want_adc[lit], rtol=1e-4)


def test_load_model_folds_the_weight_norm_and_freezes():
    flat = seeded_params(SMALL, 8)
    model = _port(flat, **SMALL)
    assert not any(p.requires_grad for p in model.parameters())
    w = model.head.v.detach().reshape(-1, model.head.v.shape[-1])
    torch.testing.assert_close(model.head.g.detach(), w.norm(dim=0))


def test_a_request_records_its_spans_nested():
    flat = seeded_params(SMALL, 9)
    cfg = RAMSConfig(**SMALL, conv_kernel=True)
    model = _port(flat, **SMALL, conv_kernel=True)
    before = dict(conv3d_kernel.LAUNCHES)
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.inference_mode():
            misr.predict_case(model, _case(side=8), cfg, 2, 1, "cpu")
    spans = profiling.recorded()
    profiling.clear()
    names = [s.name for s in spans]
    assert names.count("misr.request") == 1 and names.count("rams.forward") == 1
    for part in ("misr.draws", "misr.forward", "misr.to_host", "misr.mean", "misr.adc",
                 "rams.body", "rams.reduce", "rams.global", "rams.out"):
        assert names.count(part) == 1, part
    assert names.count("kernel.conv3d_rfab") == 2 * SMALL["N"] + 1 + 3 * 3
    assert "kernel.launch" not in names  # the plain K6 on the CPU launches nothing
    assert conv3d_kernel.LAUNCHES == before

    def inside(inner, outer):
        return (inner.thread == outer.thread and outer.start_ns <= inner.start_ns
                and inner.end_ns <= outer.end_ns)

    request = next(s for s in spans if s.name == "misr.request")
    forward = next(s for s in spans if s.name == "rams.forward")
    assert inside(forward, request)
    assert forward.parent == "misr.forward"
    convs = [s for s in spans if s.name == "kernel.conv3d_rfab"]
    assert all(inside(c, forward) for c in convs)
    assert {c.parent for c in convs} == {"rams.body", "rams.reduce"}


@pytest.mark.parametrize("draws", [4, 25])
def test_predict_case_answers_as_the_host_side_draws_and_mean_did(draws):
    """The draws gathered on the device and summed there give the answers
    of numpy's per-draw gather, stack and float32 mean bit for bit: the same
    values go in, and a sum of fewer than 256 whole numbers below 2^16 is
    exact in float32 in any order."""
    from mri_super_resolution_tpu_torch.core.adc import adc_log_ratio
    from mri_super_resolution_tpu_torch.core.interp import rescale
    from mri_super_resolution_tpu_torch.ops.tta import predict_tensor

    flat = seeded_params(SMALL, 10)
    cfg = RAMSConfig(**SMALL, conv_kernel=True)
    model = _port(flat, **SMALL, conv_kernel=True)
    case, seed = _case(seed=draws), 99
    with torch.inference_mode():
        dwi, adc = misr.predict_case(model, case, cfg, draws, seed, "cpu")
        rng = np.random.default_rng(seed)
        lor = case.dwi[:, :, 0, :].astype(np.float32) * 256.0
        stack = np.stack([lor[..., rng.choice(27, size=9, replace=False)]
                          for _ in range(draws)], axis=0)
        want = predict_tensor(model, torch.as_tensor(stack))[..., 0].numpy().mean(axis=0)
        b0 = torch.as_tensor(case.b0[:, :, 0], dtype=torch.float32)
        want_adc = adc_log_ratio(torch.as_tensor(want), rescale(b0, 3), case.b, mag=1e6).numpy()
    assert dwi.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(dwi, want)
    np.testing.assert_array_equal(adc, want_adc)
