"""The port's serving artifacts (``serve.py`` on ``torch.export``,
``cli/export_model.py``, ``superres_dwi --export_artifact``), case by case
the counterpart of ``tests/test_serve.py``, and against the JAX package's
artifacts built from the same params (flax params, and ``convert.py``'s
state dict of them), both served on the CPU with the same inputs.

Bars, read on the CPU before they were set: served against the live module
0 for SIREN, WIRE, PIA and the RAMS (the same float32 and bf16 kernels run
the program and the module), 4.0e-7 for the GridINR against its tensor
path (the in-graph interpolation matrices read the coordinates, the tensor
path ``_unit_linspace``); each held at 1e-6 of the largest magnitude, as
``tests/test_serve.py`` holds 1e-6 and 1e-5, the gather path at 1e-5.
Against the JAX artifacts, float32 programs in other orders: 5.0e-7
(SIREN with B), 1.4e-7 (SIREN), 3.7e-7 (WIRE), 3.1e-7 (GridINR) and
1.7e-7 (PIA) of the largest magnitude, held at the JAX CLI's ``--check``
bar of 1e-4; the bf16 RAMS 8.7e-3, held at the CLI's 2e-2. The
``superres_dwi`` artifacts against the pipeline's own inference: 6.5e-7
(SIREN) and 1.7e-7 (grid), at 1e-4.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu import serve as jserve
from mri_super_resolution_tpu.config import RAMSConfig as JRAMSConfig
from mri_super_resolution_tpu.core.coords import fourier_matrix as j_fourier_matrix
from mri_super_resolution_tpu.core.coords import fourier_encode as j_fourier_encode
from mri_super_resolution_tpu.models import GridINR as JGridINR
from mri_super_resolution_tpu.models import Siren as JSiren
from mri_super_resolution_tpu.models import Wire as JWire
from mri_super_resolution_tpu.models.pia import PIA as JPIA
from mri_super_resolution_tpu.pipelines.misr import build_rams as j_build_rams
from mri_super_resolution_tpu_torch import convert, serve
from mri_super_resolution_tpu_torch.cli import export_model as export_cli
from mri_super_resolution_tpu_torch.cli import superres_dwi as sr_cli
from mri_super_resolution_tpu_torch.config import RAMSConfig
from mri_super_resolution_tpu_torch.core.coords import fourier_encode, mgrid
from mri_super_resolution_tpu_torch.data import synthetic
from mri_super_resolution_tpu_torch.data.io import save_mat
from mri_super_resolution_tpu_torch.models import PIA, GridINR, Siren, SirenToy, Wire
from mri_super_resolution_tpu_torch.models.grid_inr import (
    grid_inr_apply,
    infer_tensor_grid,
)
from mri_super_resolution_tpu_torch.pipelines import superres3d
from mri_super_resolution_tpu_torch.pipelines.misr import build_rams

torch.set_num_threads(2)

LIVE_RTOL, CHECK_TOL, RAMS_TOL = 1e-6, 1e-4, 2e-2
GRID = dict(num_levels=2, base_resolution=4, features_per_level=2, hidden=8, z_divisor=1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _coords(n, d=2, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, d)).astype(np.float32)


def _axes(shape):
    return [np.linspace(-1.0, 1.0, n).astype(np.float32) for n in shape[:3]]


@pytest.fixture(scope="module")
def siren():
    """A flax SIREN with Fourier features, its port, and both artifacts."""
    jmodel = JSiren(hidden_features=32, hidden_layers=2)
    B = j_fourier_matrix(jax.random.key(1), 8, 2)
    params = jmodel.init(jax.random.key(0), j_fourier_encode(jnp.zeros((4, 2)), B))
    model = Siren(16, 32, 2)
    model.load_state_dict(convert.siren_state_dict(_np(params)))
    model.requires_grad_(False)
    return jmodel, params, np.asarray(B), model


def test_siren_roundtrip_matches_live_and_jax(siren, tmp_path):
    jmodel, params, B, model = siren
    out, jout = str(tmp_path / "inr"), str(tmp_path / "jinr")
    manifest = serve.export_inr(model, 2, out, fourier_B=torch.as_tensor(B), device="cpu",
                                model_desc="siren 32x2 + FF8")
    assert manifest["kind"] == "inr" and manifest["fourier_features"] == [8, 2]
    jserve.export_inr(jmodel.apply, params, 2, jout, fourier_B=jnp.asarray(B),
                      platforms=("cpu",))
    served, jserved = serve.load(out, device="cpu"), jserve.load(jout)
    tB = torch.as_tensor(B)
    for n in (1, 3, 57, 257):  # the symbolic batch, 1 included
        c = _coords(n, seed=n)
        got = served(torch.as_tensor(c))
        assert got.shape == (n, 1) and got.device.type == "cpu"
        assert _rel(got, model(fourier_encode(torch.as_tensor(c), tB))) <= LIVE_RTOL
        assert _rel(got, jserved(jnp.asarray(c))) <= CHECK_TOL


def test_siren_without_fourier_and_wire(tmp_path):
    for name, jmodel, tmodel, sd in (
            ("siren", JSiren(hidden_features=16, hidden_layers=1), Siren(2, 16, 1),
             convert.siren_state_dict),
            ("wire", JWire(hidden_features=16, hidden_layers=1), Wire(2, 16, 1),
             convert.wire_state_dict)):
        params = jmodel.init(jax.random.key(0), jnp.zeros((1, 2)))
        tmodel.load_state_dict(sd(_np(params)))
        tmodel.requires_grad_(False)
        out, jout = str(tmp_path / name), str(tmp_path / f"j{name}")
        assert serve.export_inr(tmodel, 2, out, device="cpu")["fourier_features"] is None
        jserve.export_inr(jmodel.apply, params, 2, jout, platforms=("cpu",))
        c = _coords(21, seed=7)
        got = serve.load(out, device="cpu")(c)  # numpy in, as the JAX artifact takes
        assert _rel(got, tmodel(torch.as_tensor(c))) <= LIVE_RTOL, name
        assert _rel(got, jserve.load(jout)(jnp.asarray(c))) <= CHECK_TOL, name


@pytest.fixture(scope="module")
def grid():
    jmodel = JGridINR(**GRID)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 4)))
    # the grids start in [0, 1e-4): spread them so the output depends on them
    params = jax.tree.map(lambda a: a * 1e4 if a.ndim == 4 else a, params)
    model = GridINR(**GRID)
    model.load_state_dict(convert.grid_inr_from_flax(_np(params)))
    model.requires_grad_(False)
    return jmodel, params, model


def test_grid_inr_serves_every_grid_from_one_artifact(grid, tmp_path):
    """One artifact serves the LR, the HR and the 2x grids (every axis
    length symbolic), against the tensor path, the pointwise gather path
    and the JAX artifact."""
    jmodel, params, model = grid
    out, jout = str(tmp_path / "grid"), str(tmp_path / "jgrid")
    manifest = serve.export_grid_inr(model, out, device="cpu", model_desc="grid 2x4x2")
    assert manifest["kind"] == "grid_inr" and manifest["nb"] == 4
    jserve.export_grid_inr(jmodel, params, jout, platforms=("cpu",))
    served, jserved = serve.load(out, device="cpu"), jserve.load(jout)
    for shape in ((4, 4, 7, 4), (8, 8, 7, 4), (16, 16, 7, 4), (8, 6, 1, 4)):
        axes = _axes(shape)
        got = served(*axes)
        assert got.shape == (*shape, 1)
        want = infer_tensor_grid(model.params(), shape, clamp_min=0.0)
        assert _rel(got.reshape(-1, 1), want) <= LIVE_RTOL, shape
        pointwise = grid_inr_apply(model.params(), mgrid(shape)).clamp_min(0.0)
        assert _rel(got.reshape(-1, 1), pointwise) <= 1e-5, shape
        assert _rel(got, jserved(*(jnp.asarray(a) for a in axes))) <= CHECK_TOL, shape


def test_rams_roundtrip_matches_live_and_jax(tmp_path):
    jmodel = j_build_rams(JRAMSConfig(filters=8, N=1))
    # flax params of the init's structure, drawn with numpy: an eager flax
    # init of RAMS takes 20 s on the CPU
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32) if a.ndim == 1 else
        rng.normal(0.0, 0.3, a.shape).astype(np.float32),
        jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 12, 12, 9))))
    model = build_rams(RAMSConfig(filters=8, N=1))
    model.load_state_dict(convert.rams_state_dict(_np(params)))
    model.requires_grad_(False)
    out, jout = str(tmp_path / "rams"), str(tmp_path / "jrams")
    assert serve.export_rams(model, out, height=12, width=12, device="cpu",
                             model_desc="tiny")["kind"] == "rams"
    jserve.export_rams(jmodel.apply, params, jout, height=12, width=12, platforms=("cpu",))
    served, jserved = serve.load(out, device="cpu"), jserve.load(jout)
    for b in (1, 5):
        x = np.random.default_rng(b).uniform(0, 1000, (b, 12, 12, 9)).astype(np.float32)
        got = served(x)
        assert got.shape == (b, 36, 36, 1)
        assert _rel(got, model(torch.as_tensor(x))) <= LIVE_RTOL
        assert _rel(got, jserved(jnp.asarray(x))) <= RAMS_TOL
    kernel_model = build_rams(RAMSConfig(filters=8, N=1, conv_kernel=True))
    with pytest.raises(ValueError, match="conv_kernel=False"):
        serve.export_rams(kernel_model, str(tmp_path / "k6"), height=12, width=12,
                          device="cpu")


def test_pia_tuple_outputs_at_several_n(tmp_path):
    jmodel = JPIA(hidden_dims=(8, 16))
    params = jmodel.init(jax.random.key(0), jnp.ones((1, 16)) * 1000.0)
    model = PIA(hidden_dims=(8, 16))
    model.load_state_dict(convert.pia_from_flax(_np(params)))
    model.requires_grad_(False)
    out, jout = str(tmp_path / "pia"), str(tmp_path / "jpia")
    assert serve.export_pia(model, out, device="cpu")["kind"] == "pia"
    encode = lambda p, x: jmodel.apply(p, x, method=JPIA.encode)  # noqa: E731
    jserve.export_pia(encode, params, jout, platforms=("cpu",))
    served, jserved = serve.load(out, device="cpu"), jserve.load(jout)
    for n in (1, 2, 7, 129):
        sig = np.random.default_rng(n).uniform(0, 1000, (n, 16)).astype(np.float32)
        got = served(sig)
        assert len(got) == 3 and all(g.shape == (n, 3) for g in got)
        for g, w, jw in zip(got, model.encode(torch.as_tensor(sig)),
                            jserved(jnp.asarray(sig))):
            assert _rel(g, w) <= LIVE_RTOL and _rel(g, jw) <= CHECK_TOL
    v = got[2].numpy()
    np.testing.assert_allclose(v.sum(-1), 1.0, atol=1e-5)
    assert (v >= 0).all()


def test_manifest_records_symbolic_shapes_and_platforms(tmp_path):
    model = Siren(2, 16, 1)
    out = str(tmp_path / "m")
    m = serve.export_inr(model, 2, out, device="cpu")
    assert m["platforms"] == ["cpu"]
    assert sorted(os.listdir(out)) == ["manifest.json", "program_cpu.pt2"]
    assert m["in_avals"] == [{"shape": ["n", "2"], "dtype": "float32"}]
    assert m["out_avals"] == [{"shape": ["n", "1"], "dtype": "float32"}]
    loaded = serve.load(out, device="cpu")
    assert loaded.manifest == json.load(open(os.path.join(out, "manifest.json")))
    assert loaded.manifest["torch_version"] == torch.__version__
    g = serve.export_grid_inr(GridINR(**GRID), str(tmp_path / "g"), device="cpu")
    assert [a["shape"] for a in g["in_avals"]] == [["nx"], ["ny"], ["nz"]]
    assert g["out_avals"][0]["shape"] == ["nx", "ny", "nz", "4", "1"]


def test_load_refuses_what_the_artifact_lacks(tmp_path):
    with pytest.raises(FileNotFoundError):
        serve.load(str(tmp_path / "nope"), device="cpu")
    out = str(tmp_path / "m")
    serve.export_inr(Siren(2, 16, 1), 2, out, device="cpu")
    manifest = json.load(open(os.path.join(out, "manifest.json")))
    json.dump(dict(manifest, platforms=["cuda"]), open(os.path.join(out, "manifest.json"), "w"))
    with pytest.raises(ValueError, match="not for 'cpu'"):
        serve.load(out, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve.load(out)  # the default device is the card


def test_export_model_cli_subcommands_with_check(tmp_path):
    gen = torch.Generator().manual_seed(3)
    toy = str(tmp_path / "toy.pt")
    torch.save(SirenToy(2, 16, 1, generator=gen).state_dict(), toy)
    m = export_cli.main(["inr", "--params", toy, "--hidden_features", "16", "--hidden_layers",
                         "1", "--out", str(tmp_path / "a_inr"), "--device", "cpu", "--check"])
    assert m["kind"] == "inr" and m["check_rel_err"] <= LIVE_RTOL
    np.save(tmp_path / "B.npy", np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32))
    siren = str(tmp_path / "siren.pt")
    torch.save(Siren(8, 16, 1, generator=gen).state_dict(), siren)
    m = export_cli.main(["inr", "--model", "siren", "--params", siren, "--coord_dim", "3",
                         "--fourier_B", str(tmp_path / "B.npy"), "--hidden_features", "16",
                         "--hidden_layers", "1", "--out", str(tmp_path / "a_ff"), "--device",
                         "cpu", "--check"])
    assert m["fourier_features"] == [4, 3] and m["check_rel_err"] <= LIVE_RTOL
    wire = str(tmp_path / "wire.pt")
    torch.save(Wire(2, 16, 1, generator=gen).state_dict(), wire)
    m = export_cli.main(["inr", "--model", "wire", "--params", wire, "--hidden_features", "16",
                         "--hidden_layers", "1", "--out", str(tmp_path / "a_wire"),
                         "--device", "cpu", "--check"])
    assert m["check_rel_err"] <= LIVE_RTOL
    grid_pt = str(tmp_path / "grid.pt")
    torch.save(GridINR(**GRID, generator=gen).state_dict(), grid_pt)
    m = export_cli.main(["grid", "--params", grid_pt, "--levels", "2", "--base_resolution",
                         "4", "--features", "2", "--hidden", "8", "--out",
                         str(tmp_path / "a_grid"), "--device", "cpu", "--check"])
    assert m["kind"] == "grid_inr" and m["check_rel_err"] <= LIVE_RTOL
    pia_pt = str(tmp_path / "pia.pt")
    torch.save(PIA(generator=gen).state_dict(), pia_pt)
    m = export_cli.main(["pia", "--params", pia_pt, "--out", str(tmp_path / "a_pia"),
                         "--device", "cpu", "--check"])
    assert m["kind"] == "pia" and m["check_rel_err"] <= LIVE_RTOL
    # the committed RAMS checkpoint, at a small patch size
    m = export_cli.main(["rams", "--height", "12", "--width", "12", "--out",
                         str(tmp_path / "a_rams"), "--device", "cpu", "--check"])
    assert m["kind"] == "rams" and m["check_rel_err"] <= LIVE_RTOL
    assert m["in_avals"][0]["shape"] == ["b", "12", "12", "9"]


def test_export_model_cli_check_fails_on_a_mismatch(tmp_path, monkeypatch):
    pia_pt = str(tmp_path / "pia.pt")
    torch.save(PIA(generator=torch.Generator().manual_seed(0)).state_dict(), pia_pt)
    real_load = serve.load

    def tampered(path, device="cuda"):  # an artifact of other weights
        served = real_load(path, device)
        served._module = lambda x: tuple(t + 1.0 for t in served.program.module()(x))
        return served

    monkeypatch.setattr(export_cli.serve, "load", tampered)
    with pytest.raises(SystemExit):
        export_cli.main(["pia", "--params", pia_pt, "--out", str(tmp_path / "p"), "--device",
                         "cpu", "--check"])


@pytest.mark.parametrize("preset", [[], ["--preset", "quality", "--grid_levels", "2",
                                         "--grid_base_resolution", "4", "--grid_hidden", "8"]])
def test_superres_dwi_export_artifact(tmp_path, monkeypatch, preset):
    """``superres_dwi --export_artifact`` on a tiny patient: the artifact,
    served on the HR axes, against the fitted INR on the pipeline's own
    inference route (the plain one on the CPU)."""
    b0 = np.abs(np.random.default_rng(2).normal(1.0, 0.3, (24, 24, 3))).astype(np.float32)
    hybrid = synthetic.hybrid_from_b0(b0, acq_counts=(1, 2, 2, 2), seed=2)
    mat = np.empty((4, 4), dtype=object)
    for b in range(4):
        for te in range(4):
            mat[b, te] = hybrid[b][te]
    path = str(tmp_path / "p7" / "master.mat")
    save_mat(path, {"hybrid_raw": mat, "b": np.asarray([[0.0, 150.0, 1000.0, 1500.0]])})
    results, run_patient = [], superres3d.run_patient

    def recording(*args, **kwargs):
        results.append(run_patient(*args, **kwargs))
        return results[-1]

    monkeypatch.setattr(superres3d, "run_patient", recording)
    out = str(tmp_path / "out")
    sr_cli.main(["--master_mats", path, "--epochs", "4", "--pn_epochs", "2", "--hidden_dim",
                 "16", "--num_layers", "1", "--mapping_size", "8", "--roi_start", "4",
                 "--roi_end", "20", "--device", "cpu", "--out", out, "--export_artifact",
                 *preset])
    (res,) = results
    art = os.path.join(out, "patp7", "artifact")
    served = serve.load(art, device="cpu")
    assert served.manifest["platforms"] == ["cpu"]
    np.testing.assert_allclose(served.manifest["maxes"], res.maxes)
    assert served.manifest["bvalues"] == [0.0, 150.0, 1000.0, 1500.0]
    hr_shape = res.sr_hr_grid.shape  # (16, 16, 3, 4)
    if preset:
        assert served.manifest["kind"] == "grid_inr"
        got = served(*_axes(hr_shape)).reshape(-1, 1)
        want = res.sr_hr_grid.reshape(-1, 1)  # the tensor path, clamped at 0 as served
    else:
        assert served.manifest["kind"] == "inr" and served.manifest["fourier_features"] == [8, 4]
        got = served(mgrid(hr_shape))
        route = superres3d._route(superres3d.SupperresDWIConfig(), res.inr,
                                  torch.as_tensor(res.B))
        want = route.infer(hr_shape)  # unclamped, as the INR artifact serves it
    assert _rel(got, want) <= CHECK_TOL
    shutil.rmtree(out)
