"""The port imports neither JAX nor the JAX package: every module of it
imports, and short CPU fits of the SIREN and WIRE paths, a tiny MISR run
(the K6 route, its plain version on the CPU), a two-step tiny MISR
training run (K6 and K7 routes, their plain versions), a two-step
``fit_ensemble_batched`` and ``fit_until`` (K1's batched weighted and
absmax variants, their plain versions), the P1 probe's plain version, a two-step GridINR
fit, the cubic-spline resample ``resize_along_axis``, a two-epoch hybrid
fit in its SIREN and grid arms (each one batched fit), a 2-iteration
NLLS ``hybrid_fit`` run, a two-step half-res quality slice
(``lowres_qual.run_slice``) and a two-step cohort fit
(``cohort.run_cohort``), in a process where both are blocked, launching
nothing; the parallel layer, the loaders, the profiling helpers and the
three examples are among the modules imported. The CSV analysis and the LR panel CLI also import with
pandas, matplotlib and seaborn blocked (the card's machine has none). With
JAX, the JAX package and matplotlib blocked, a blinded qualitative-study
panel (``qual_study.build_panel``, two fine-tune steps) is built and
scored, a SIREN is exported, loaded and served, and the INR differential
operators run; ``save_panel``, the one user of matplotlib, raises, and the
``prepare_qual_images`` CLI stops before its first fit, naming matplotlib."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "flax", "optax", "orbax", "mri_super_resolution_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import torch
torch.set_num_threads(2)
import mri_super_resolution_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
for m in ("parallel.mesh", "parallel.sharded_fit", "parallel.tp_fit", "parallel.distributed",
          "parallel.dryrun", "pipelines.cohort", "cli.cohort_run", "data.native_io",
          "data.preprocessing", "data.tfckpt", "utils.profiling", "examples.phantom_sanity",
          "examples.sr3d_demo", "examples.wire_vs_siren"):
    assert pkg.__name__ + "." + m in mods, m
from mri_super_resolution_tpu_torch.core.coords import fourier_encode, fourier_matrix, mgrid
from mri_super_resolution_tpu_torch.fit.engine import fit_simple
from mri_super_resolution_tpu_torch.fit.optim import Adam
from mri_super_resolution_tpu_torch.models import Siren
from mri_super_resolution_tpu_torch.ops.siren_kernel import LAUNCHES, siren_loss_grads
g = torch.Generator().manual_seed(0)
B = fourier_matrix(g, 8, 2)
x = fourier_encode(mgrid((6, 5)), B)
inr = Siren(16, 32, 1, generator=g)
inr.requires_grad_(False)
t = torch.rand(30, 1, generator=g)
res = fit_simple(None, Adam(inr.weights(), 1e-3), x, t, 2,
                 value_and_grad_fn=lambda p, xx, tt: siren_loss_grads(xx, p, tt))
assert res.losses.shape == (2,) and bool(torch.isfinite(res.losses).all())
assert sum(LAUNCHES.values()) == 0
from mri_super_resolution_tpu_torch.models import Wire
from mri_super_resolution_tpu_torch.ops import wire_kernel as wk
w = Wire(4, 16, 1, generator=g)
w.requires_grad_(False)
res = fit_simple(None, Adam(w.params(), 1e-3), mgrid((3, 2, 2, 4)), torch.rand(48, 1, generator=g),
                 2, value_and_grad_fn=wk.make_wire_value_and_grad(1))
assert bool(torch.isfinite(res.losses).all())
assert wk.make_wire_fused_apply(1)(w.params(), mgrid((2, 2, 2, 2))).shape == (16, 1)
assert sum(wk.LAUNCHES.values()) == 0
import os, tempfile
import numpy as np
from mri_super_resolution_tpu_torch.config import RAMSConfig
from mri_super_resolution_tpu_torch.data import Case
from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck
from mri_super_resolution_tpu_torch.pipelines import misr
rng = np.random.default_rng(0)
case = Case(pt_id="pat-1", b=900.0, cancer_loc=(2, 2), contralateral_loc=(3, 3),
            noise=(1, 1), cancer_slice=0, acquisitions=(9,),
            dwi=rng.uniform(20, 40, (8, 8, 1, 9)).astype(np.float32),
            b0=rng.uniform(30, 50, (8, 8, 1)).astype(np.float32),
            erd=np.ones((8, 8, 1), np.float32), accept=np.ones((8, 8, 1, 9), np.int32))
cfg = RAMSConfig(filters=8, N=1, conv_kernel=True)
with tempfile.TemporaryDirectory() as out:
    misr.run([case], cfg, misr.build_rams(cfg, generator=g).state_dict(), out,
             exp_name="e", sample_size=2, device="cpu")
    assert os.path.isfile(os.path.join(out, "e", "1", "DWI", "mean.dcm"))
assert ck.LAUNCHES["conv3d_rfab"] == 0
from mri_super_resolution_tpu_torch.config import TrainerConfig
from mri_super_resolution_tpu_torch.fit.trainer import Trainer
x = rng.uniform(7000, 8000, (2, 8, 8, 9)).astype(np.float32)
y = rng.uniform(7000, 8000, (2, 24, 24, 1)).astype(np.float32)
import contextlib, io
with tempfile.TemporaryDirectory() as out, contextlib.redirect_stdout(io.StringIO()):
    tr = Trainer(misr.build_rams(cfg, generator=g),
                 TrainerConfig(batch_size=1, epochs=1, hr_size=24, checkpoint_dir=out,
                               log_dir=out), device="cpu")
    tr.init()
    assert tr.fit(x, (y, np.ones_like(y))).step == 2
    assert tr.manager.latest_step() == 2
assert ck.LAUNCHES == {"conv3d_rfab": 0, "conv3d_rfab_bwd": 0, "conv3d_rfab_wg": 0}
from mri_super_resolution_tpu_torch.fit.engine import (fit_ensemble_batched, fit_until,
                                                      plain_apply_init)
from mri_super_resolution_tpu_torch.fit.optim import StackedAdam
from mri_super_resolution_tpu_torch.models import SirenERD
from mri_super_resolution_tpu_torch.ops import siren_kernel as sk
s2 = Siren(2, 16, 1, generator=g)
s2.requires_grad_(False)
c = mgrid((5, 6))
res = fit_ensemble_batched(
    lambda p, xx: sk.siren_forward_batched_ref(xx, p), StackedAdam([w[None] for w in s2.weights()],
                                                                   1e-3),
    c, torch.rand(1, 3, 30, 1, generator=g), torch.ones(1, 3, 30, 1), c, mgrid((10, 12)), 2, 1,
    weighted_value_and_grad_fn=sk.make_fused_weighted_value_and_grad_batched(s2))
assert res.pred_scale.shape == (1, 120, 1) and bool(torch.isfinite(res.losses).all())
erd = SirenERD(2, 16, 1, perturb=True, generator=g)
apply_fn, init_fn = plain_apply_init(erd, g)
fu = fit_until(apply_fn, 1e-3, init_fn, c, torch.rand(30, 1, generator=g), 0.0, 2,
               sk.make_fused_value_grad_absmax(erd))
assert fu.steps == 2 and len(fu.losses) == 2
from mri_super_resolution_tpu_torch.ops import mma_probe as mp
assert mp.mma_probe(torch.ones(4, 8, dtype=torch.int8), torch.ones(8, 8, dtype=torch.int8),
                    2, 3).shape == (2, 8)
from mri_super_resolution_tpu_torch.models import GridINR
from mri_super_resolution_tpu_torch.models.grid_inr import make_tensor_value_and_grad
gi = GridINR(num_levels=2, base_resolution=4, features_per_level=2, hidden=8, z_divisor=1,
             generator=g)
gi.requires_grad_(False)
res = fit_simple(None, Adam(gi.params(), 5e-3), mgrid((4, 3, 2, 4)), torch.rand(96, 1, generator=g),
                 2, value_and_grad_fn=make_tensor_value_and_grad((4, 3, 2, 4)))
assert res.losses.shape == (2,) and bool(torch.isfinite(res.losses).all())
from mri_super_resolution_tpu_torch.core.interp import resize_along_axis
up = resize_along_axis(torch.rand(3, 4, 6, generator=g), 10)
assert up.shape == (3, 4, 10) and bool(torch.isfinite(up).all())
from mri_super_resolution_tpu_torch.data import synthetic
from mri_super_resolution_tpu_torch.pipelines import hybrid as hy
h = hy.mean_over_acquisitions(synthetic.hybrid_from_b0(
    rng.uniform(0.5, 1.5, (12, 12, 2)).astype(np.float32), acq_counts=(1, 2, 2, 2), seed=0))
for arm in ("siren", "grid"):
    r = hy.fit_all_te(h, hy.HybridConfig(number_of_epochs=2, hidden_dim=16, num_layers=1,
                                         mapping_size=4, roi_start_x=2, roi_end_x=10,
                                         roi_start_y=2, roi_end_y=10, inr_model=arm,
                                         grid_levels=2, grid_base_resolution=4,
                                         grid_hidden=8), device="cpu")
    assert r.recon_hybrid.shape == (16, 16, 2, 4, 4) and r.losses.shape == (4, 2)
from mri_super_resolution_tpu_torch.ops.nlls import hybrid_fit
D, T2, v = hybrid_fit(torch.rand(5, 16, generator=g) * 1000, iters=2)
assert D.shape == T2.shape == v.shape == (5, 3)
from mri_super_resolution_tpu_torch.pipelines import inr_erd, lowres_qual
b0 = rng.uniform(0.8, 1.6, (12, 12, 1)).astype(np.float32)
erd_case = inr_erd.ERDCase(pt_id="pat-1", b=(0.0, 150.0, 1000.0, 1500.0), cancer_loc=(6, 6),
                           contralateral_loc=(4, 4), noise=(8, 8), cancer_slice=0, b0=b0,
                           b3=np.stack([0.5 * b0] * 3, -1))
lq = lowres_qual.run_slice(erd_case, 0, lowres_qual.LowresQualConfig(
    hidden_features=16, hidden_layers=1, loss_threshold=0.0, max_pretrain_steps=2,
    phase2_steps=2), device="cpu")
assert lq.pretrain_steps == 2 and lq.sr.shape == (12, 12) and np.isfinite(lq.metrics).all()
from mri_super_resolution_tpu_torch.pipelines import cohort
cr = cohort.run_cohort([case, case], num_steps=2, hidden_features=8, hidden_layers=1,
                       roi=(1, 7), device="cpu")
assert cr.losses.shape == (2, 2) and cr.recons.shape == (2, 6, 6)
assert not any(sk.LAUNCHES.values()) and not any(mp.LAUNCHES.values())
assert not any(ck.LAUNCHES.values()) and not any(wk.LAUNCHES.values())
assert not any(k == "jax" or k.startswith(("jax.", "flax", "optax", "orbax",
                                           "mri_super_resolution_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("OK", len(mods))
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                          text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")
    assert int(proc.stdout.split()[1]) >= 25  # every module was imported


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py (the on-card run) names neither JAX nor the JAX package
    in its imports."""
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    imports = [ln.strip() for ln in src.splitlines()
               if ln.strip().startswith(("import ", "from "))]
    assert imports
    for ln in imports:
        mod = ln.split()[1]
        assert not (mod == "jax" or mod.startswith(("jax.", "flax", "optax"))
                    or mod == "mri_super_resolution_tpu"
                    or mod.startswith("mri_super_resolution_tpu.")), ln


def test_analysis_imports_without_plotting_libraries():
    """utils/analysis.py and the two CPU-only CLIs import their plotting and
    table libraries inside the functions that use them."""
    script = (
        "import importlib, sys\n"
        "for name in ('pandas', 'matplotlib', 'seaborn', 'jax', 'mri_super_resolution_tpu'):\n"
        "    sys.modules[name] = None\n"
        "for m in ('utils.analysis', 'cli.select_lrs', 'cli.analyze_results'):\n"
        "    importlib.import_module('mri_super_resolution_tpu_torch.' + m)\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"


QUAL_SERVE_SCRIPT = r"""
import sys, tempfile
for name in ("jax", "flax", "optax", "orbax", "mri_super_resolution_tpu", "matplotlib"):
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(2)
from mri_super_resolution_tpu_torch import serve
from mri_super_resolution_tpu_torch.config import INRERDConfig
from mri_super_resolution_tpu_torch.core.autodiff import gradient, laplace
from mri_super_resolution_tpu_torch.core.coords import fourier_encode, fourier_matrix
from mri_super_resolution_tpu_torch.models import Siren
from mri_super_resolution_tpu_torch.ops import siren_kernel as sk
from mri_super_resolution_tpu_torch.pipelines import inr_erd, qual_study
rng = np.random.default_rng(0)
b0 = rng.uniform(0.8, 1.6, (16, 16, 1)).astype(np.float32)
case = inr_erd.ERDCase(pt_id="pat-1", b=(0.0, 150.0, 1000.0, 1500.0), cancer_loc=(8, 8),
                       contralateral_loc=(4, 4), noise=(10, 10), cancer_slice=0, b0=b0,
                       b3=np.stack([0.5 * b0 + 0.01 * rng.normal(size=b0.shape)] * 3,
                                   -1).astype(np.float32))
panel = qual_study.build_panel(case, 0, INRERDConfig(hidden_features=16, hidden_layers=1,
                                                     loss_threshold=1.0),
                               fine_tune_steps=2, device="cpu")
assert panel.sr.shape == (16, 16) and sorted(panel.order) == sorted(qual_study.ARMS)
with tempfile.TemporaryDirectory() as out:
    path = qual_study.score_panels({1: panel}, out + "/s.csv", device="cpu")
    assert len(open(path).read().splitlines()) == 2
    try:
        qual_study.save_panel(panel, out + "/p.png")
        raise AssertionError("save_panel drew without matplotlib")
    except ImportError:
        pass
    from mri_super_resolution_tpu_torch.cli import prepare_qual_images
    try:
        prepare_qual_images.main(["--data_dir", out, "--device", "cpu", "--out_dir", out])
        raise AssertionError("prepare_qual_images ran without matplotlib")
    except ImportError as e:
        assert "matplotlib" in str(e)
    g = torch.Generator().manual_seed(0)
    B = fourier_matrix(g, 4, 2)
    inr = Siren(8, 16, 1, generator=g)
    serve.export_inr(inr, 2, out + "/a", fourier_B=B, device="cpu")
    c = torch.rand(5, 2, generator=g) * 2 - 1
    with torch.no_grad():
        assert torch.equal(serve.load(out + "/a", device="cpu")(c), inr(fourier_encode(c, B)))
f = lambda x: inr(fourier_encode(x, B))
assert gradient(f, c).shape == (5, 2) and laplace(f, c).shape == (5,)
assert not any(sk.LAUNCHES.values())
assert not any(k == "jax" or k.startswith(("jax.", "flax", "optax", "orbax", "matplotlib",
                                           "mri_super_resolution_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("OK")
"""


def test_qual_study_and_serving_run_without_jax_or_matplotlib():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", QUAL_SERVE_SCRIPT], capture_output=True,
                          text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
