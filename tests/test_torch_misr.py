"""The port's MISR inference path against the JAX package's: the case
registry, the TTA wrappers, ``predict_case`` and ``run`` on the tiny case of
``tests/test_misr_pipeline.py``, and the ``misr_master`` CLI on the CPU.

JAX-drawn RAMS params reach the port through ``convert.py`` (the CLI test
through an ``.npz`` written with ``convert.save_params_npz``). The tiny RAMS
has 8 filters so that the K6 gate opens; on CPU tensors K6 runs its plain
version and no kernel launches.

Measured gaps (on the CPU): the draws are the same (an apply that lays the
9 drawn acquisitions out as a 3x3 block gives equal mean predictions). In
float32 the mean prediction of ``predict_case`` is within 0.336 of the JAX
one: a mean of 3 rounded predictions, one of which rounded the other way
(tol 1/3 + 2^-7, the float32 spacing near 65536); the ADC within 0.049 (tol 0.2). In bf16 the gap is 4.0 at
DWI magnitudes and 1569 on the clipping tiny case, against the JAX model's
own bf16-vs-float32 gaps of 18 and 4667 on the same inputs (the bounds).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from mri_super_resolution_tpu.config import RAMSConfig as JRAMSConfig
from mri_super_resolution_tpu.core import adc as jadc
from mri_super_resolution_tpu.data import cases as jcases
from mri_super_resolution_tpu.models import rams as jrams
from mri_super_resolution_tpu.ops import tta as jtta
from mri_super_resolution_tpu.pipelines import misr as jmisr
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.cli import misr_master
from mri_super_resolution_tpu_torch.config import RAMSConfig
from mri_super_resolution_tpu_torch.core.adc import adc_log_ratio
from mri_super_resolution_tpu_torch.data import cases as tcases
from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck
from mri_super_resolution_tpu_torch.ops import tta
from mri_super_resolution_tpu_torch.pipelines import misr

torch.set_num_threads(2)

TINY = dict(filters=8, N=1, channels=9, r=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _case_fields(H=12, W=12, S=3, A=6, seed=0) -> dict:
    """The tiny case of tests/test_misr_pipeline.py (A < 9: draws with
    replacement)."""
    rng = np.random.default_rng(seed)
    return dict(pt_id="pat-99", b=800.0, cancer_loc=(4, 4), contralateral_loc=(8, 8),
                noise=(1, 1), cancer_slice=1, acquisitions=(A,),
                dwi=rng.uniform(6000, 9000, (H, W, S, A)).astype(np.float32),
                b0=rng.uniform(9000, 12000, (H, W, S)).astype(np.float32),
                erd=np.ones((H, W, S), np.float32),
                accept=np.ones((H, W, S, A), np.int32), synthetic_dwi=True)


@pytest.fixture(scope="module")
def tiny_params():
    x = jnp.zeros((1, 12, 12, 9), jnp.float32)
    return jrams.RAMS(**TINY).init(jax.random.key(0), x)


def _models(params, dtype, conv_kernel):
    jcfg = JRAMSConfig(**TINY, compute_dtype=dtype, conv_kernel=conv_kernel)
    tcfg = RAMSConfig(**TINY, compute_dtype=dtype, conv_kernel=conv_kernel)
    jm = jmisr.build_rams(jcfg)
    tm = misr.build_rams(tcfg)
    tm.load_state_dict(convert.rams_state_dict(_np(params)))
    return jcfg, jax.jit(lambda t: jm.apply(params, t)), tcfg, tm


def test_adc_log_ratio_matches_jax():
    rng = np.random.default_rng(1)
    dwi = rng.uniform(10, 9000, (9, 7)).astype(np.float32)
    b0 = rng.uniform(9000, 12000, (9, 7)).astype(np.float32)
    ref = np.asarray(jadc.adc_log_ratio(jnp.asarray(dwi), jnp.asarray(b0), 900.0, mag=1e6))
    got = adc_log_ratio(torch.as_tensor(dwi), torch.as_tensor(b0), 900.0, mag=1e6).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-3)


def test_same_draws_as_jax():
    """An apply that lays the 9 drawn acquisitions out as a 3x3 block makes
    the mean prediction a function of the draws alone."""
    jc, tc = jcases.Case(**_case_fields()), tcases.Case(**_case_fields())
    cfg_j, cfg_t = JRAMSConfig(**TINY), RAMSConfig(**TINY)

    def japply(x):
        return jrams.depth_to_space(x / 256.0, 3)

    def tapply(x):
        from mri_super_resolution_tpu_torch.models.rams import depth_to_space
        return depth_to_space(x / 256.0, 3)

    for seed in (0, 7):
        mj, aj = jmisr.predict_case(japply, jc, cfg_j, sample_size=4, seed=seed)
        mt, at = misr.predict_case(tapply, tc, cfg_t, sample_size=4, seed=seed, device="cpu")
        np.testing.assert_array_equal(mt, mj)
        np.testing.assert_allclose(at, aj, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("dwi_range", [(6000, 9000), (20, 40)],
                         ids=["tiny-case", "dwi-tens"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predict_case_matches_jax(tiny_params, dtype, dwi_range):
    """The tiny case as tests/test_misr_pipeline.py has it (x256 lands far
    above the uint16 range: most predictions clip) and at DWI magnitudes
    (tens: x256 lands near the PROBA-V mean)."""
    fields = _case_fields()
    rng = np.random.default_rng(1)
    lo, hi = dwi_range
    fields["dwi"] = rng.uniform(lo, hi, fields["dwi"].shape).astype(np.float32)
    fields["b0"] = rng.uniform(1.3 * lo, 1.3 * hi, fields["b0"].shape).astype(np.float32)
    jcfg, japply, tcfg, _ = _models(tiny_params, dtype, conv_kernel=False)
    mj, aj = jmisr.predict_case(japply, jcases.Case(**fields), jcfg, sample_size=3, seed=5)
    tcfg.conv_kernel = True  # the K6 route: its plain version on the CPU
    tm = misr.build_rams(tcfg)
    tm.load_state_dict(convert.rams_state_dict(_np(tiny_params)))
    ck.reset_launches()
    with torch.inference_mode():
        mt, at = misr.predict_case(tm, tcases.Case(**fields), tcfg, sample_size=3, seed=5,
                                   device="cpu")
    assert ck.LAUNCHES["conv3d_rfab"] == 0
    assert mt.shape == at.shape == (36, 36)
    assert np.isfinite(mt).all() and np.isfinite(at).all()
    if dtype == "float32":
        # one of the 3 rounded draws may round the other way: 1/3 of the
        # mean, plus the float32 spacing near 65536
        np.testing.assert_allclose(mt, mj, rtol=0, atol=1 / 3 + 2.0 ** -7)
        np.testing.assert_allclose(at, aj, rtol=0, atol=0.2)
    else:
        # bounded by the JAX model's own bf16-vs-f32 gap on this case
        m32 = jmisr.predict_case(_models(tiny_params, "float32", False)[1],
                                 jcases.Case(**fields), jcfg, sample_size=3, seed=5)[0]
        assert np.abs(mt - mj).max() <= np.abs(mj - m32).max()


def _dicom_pixels(path, n):
    with open(path, "rb") as f:
        return np.frombuffer(f.read()[-2 * n:], dtype="<i2")


def test_run_matches_jax(tmp_path, tiny_params):
    """run() on the tiny case, float32: DICOMs of the same images and a
    timings.json that names the CPU."""
    jcfg = JRAMSConfig(**TINY, compute_dtype="float32")
    tcfg = RAMSConfig(**TINY, compute_dtype="float32", conv_kernel=True)
    jmisr.run([jcases.Case(**_case_fields())], jcfg, tiny_params, str(tmp_path / "j"),
              exp_name="t", sample_size=2)
    misr.run([tcases.Case(**_case_fields())], tcfg,
             convert.rams_state_dict(_np(tiny_params)), str(tmp_path / "t"),
             exp_name="t", sample_size=2, device="cpu")
    for kind in ("DWI", "ADC"):
        a = _dicom_pixels(tmp_path / "j" / "t" / "99" / kind / "mean.dcm", 36 * 36)
        b = _dicom_pixels(tmp_path / "t" / "t" / "99" / kind / "mean.dcm", 36 * 36)
        diff = (a.astype(np.int64) - b + 32768) % 65536 - 32768  # int16 wraps alike
        assert np.abs(diff).max() <= 1, kind
    timings = json.loads((tmp_path / "t" / "t" / "timings.json").read_text())
    assert timings["platform"] == "cpu" and timings["conv_kernel"] is True
    (row,) = timings["cases"]
    assert row["pt_no"] == "99" and row["draws"] == 2 and row["predict_s"] > 0


def test_run_refuses_a_missing_card(tmp_path, tiny_params):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        misr.run([tcases.Case(**_case_fields())], RAMSConfig(**TINY),
                 convert.rams_state_dict(_np(tiny_params)), str(tmp_path))


# ---------------------------------------------------------------------------
# the case registry and the CLI
# ---------------------------------------------------------------------------


def _data_dir(root, pt_nos=("07", "08"), seed=0):
    """pat*_mean_b0.mat / pat*_ERD.mat of (12, 12, 12), enough slices for
    the registry's cancer slices 10 and 11."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for no in pt_nos:
        sio.savemat(root / f"pat{no}_mean_b0.mat",
                    {"data_mean_b0": rng.uniform(20, 60, (12, 12, 12)).astype(np.float32)})
        sio.savemat(root / f"pat{no}_ERD.mat",
                    {"ADC_alldata_mm_ERD": rng.uniform(0, 3, (12, 12, 12)).astype(np.float32)})
    return root


def test_load_cases_matches_jax(tmp_path):
    d = _data_dir(tmp_path / "data")
    assert ([r["pt_id"] for r in tcases.available_patients(str(d))]
            == [r["pt_id"] for r in jcases.available_patients(str(d))]
            == ["18-1681-07", "18-1681-08"])
    a = jcases.load_cases(str(d))
    b = tcases.load_cases(str(d))
    assert len(a) == len(b) == 2 and len(tcases.load_cases(str(d), limit=1)) == 1
    for ca, cb in zip(a, b):
        for field in ("pt_id", "b", "cancer_loc", "contralateral_loc", "noise",
                      "cancer_slice", "acquisitions", "synthetic_dwi"):
            assert getattr(ca, field) == getattr(cb, field), field
        for field in ("dwi", "b0", "erd", "accept"):
            np.testing.assert_array_equal(getattr(cb, field), getattr(ca, field))
        assert cb.dwi.shape == (12, 12, 12, 27) and cb.pt_no == ca.pt_no


def test_cli_matches_jax_pipeline(tmp_path, monkeypatch):
    """The CLI with an .npz of JAX params (filters 8, N 1, the CLI's r 8),
    --device cpu and K6's plain version, against the JAX package's run() on
    the same cases and params (bf16, the RAMSConfig default, on both
    sides)."""
    d = _data_dir(tmp_path / "data", pt_nos=("07",))
    ckpt = tmp_path / "params.npz"
    params = jrams.RAMS(filters=8, N=1).init(jax.random.key(2), jnp.zeros((1, 12, 12, 9)))
    convert.save_params_npz(_np(params), str(ckpt))
    monkeypatch.setenv("MRI_SR_DATA_DIR", str(d))
    misr_master.main(["--ckpt", str(ckpt), "--filters", "8", "--N", "1", "--sample_size", "2",
                      "--device", "cpu", "--conv_kernel", "--out_img_folder",
                      str(tmp_path / "t"), "--exp_name", "e"])
    jcfg = JRAMSConfig(filters=8, N=1)
    params = jax.tree.map(jnp.asarray, convert.load_params_npz(str(ckpt)))
    jmisr.run(jcases.load_cases(str(d)), jcfg, params, str(tmp_path / "j"), exp_name="e",
              sample_size=2)
    a = _dicom_pixels(tmp_path / "j" / "e" / "07" / "DWI" / "mean.dcm", 36 * 36)
    b = _dicom_pixels(tmp_path / "t" / "e" / "07" / "DWI" / "mean.dcm", 36 * 36)
    diff = (a.astype(np.int64) - b + 32768) % 65536 - 32768
    assert np.abs(diff).max() <= 4
    assert (tmp_path / "t" / "e" / "07" / "ADC" / "mean.dcm").exists()


def test_cli_untrained_and_refusals(tmp_path, monkeypatch, capsys):
    d = _data_dir(tmp_path / "data", pt_nos=("08",))
    monkeypatch.setenv("MRI_SR_DATA_DIR", str(d))
    misr_master.main(["--allow_untrained", "--filters", "8", "--N", "1", "--sample_size",
                      "2", "--device", "cpu", "--out_img_folder", str(tmp_path / "o")])
    assert "untrained" in capsys.readouterr().out
    timings = json.loads((tmp_path / "o" / "sr2" / "timings.json").read_text())
    assert timings["platform"] == "cpu" and timings["filters"] == 8
    with pytest.raises(SystemExit):  # (8, 1) has no committed checkpoint
        misr_master.main(["--filters", "8", "--N", "1", "--device", "cpu"])
    monkeypatch.setenv("MRI_SR_DATA_DIR", str(tmp_path / "empty"))
    with pytest.raises(SystemExit):  # no cases
        misr_master.main(["--allow_untrained", "--device", "cpu"])


# ---------------------------------------------------------------------------
# test-time augmentation
# ---------------------------------------------------------------------------


def test_predict_tensor_clips_and_rounds():
    x = np.random.default_rng(0).uniform(-100, 70000, (1, 4, 4, 9)).astype(np.float32)
    ref = np.asarray(jtta.predict_tensor(lambda t: t * 1.3 - 7.5, jnp.asarray(x)))
    got = tta.predict_tensor(lambda t: t * 1.3 - 7.5, torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [(1, 6, 6, 9), (1, 6, 5, 9)])  # batched, per variant
def test_geometric_ensemble_matches_jax(tiny_params, shape):
    _, japply, _, tm = _models(tiny_params, "float32", conv_kernel=False)
    x = np.random.default_rng(2).uniform(6000, 9000, shape).astype(np.float32)
    ref = jtta.geometric_ensemble_predict(japply, jnp.asarray(x))
    with torch.inference_mode():
        got = tta.geometric_ensemble_predict(tm, torch.as_tensor(x))
    assert got.shape == ref.shape == (1, 18, shape[2] * 3, 1)
    # each variant is rounded: a float32 flip moves one of 8 by 1
    np.testing.assert_allclose(got, ref, rtol=0, atol=0.25)


def test_shuffled_ensembles_are_seeded():
    def apply(x):  # permutation-invariant in T
        up = x.mean(-1, keepdim=True).repeat_interleave(3, 1).repeat_interleave(3, 2)
        return up

    x = torch.as_tensor(np.random.default_rng(3).uniform(0, 100, (2, 4, 4, 9)),
                        dtype=torch.float32)
    plain = tta.predict_tensor(apply, x).numpy()
    for fn in (lambda g: tta.geometric_ensemble_predict(apply, x, generator=g),
               lambda g: tta.temporal_permute_predict(apply, x, g, n_ens=3)):
        a = fn(torch.Generator().manual_seed(4))
        b = fn(torch.Generator().manual_seed(4))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, plain, atol=1.0)
