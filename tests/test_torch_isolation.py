"""The port imports neither JAX nor the JAX package: every module of it
imports, and short CPU fits of the SIREN and WIRE paths, a tiny MISR run
(the K6 route, its plain version on the CPU), a two-step tiny MISR
training run (K6 and K7 routes, their plain versions), a two-step
``fit_ensemble`` and ``fit_until`` (K1's weighted and absmax variants,
their plain versions) and the P1 probe's plain version run, in a process
where both are blocked, launching nothing."""
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
assert ck.LAUNCHES == {"conv3d_rfab": 0, "conv3d_rfab_bwd": 0}
from mri_super_resolution_tpu_torch.fit.engine import fit_ensemble, fit_until, plain_apply_init
from mri_super_resolution_tpu_torch.models import SirenERD
from mri_super_resolution_tpu_torch.ops import siren_kernel as sk
s2 = Siren(2, 16, 1, generator=g)
s2.requires_grad_(False)
c = mgrid((5, 6))
res = fit_ensemble(lambda p, xx: sk.siren_forward_ref(xx, p), Adam(s2.weights(), 1e-3), c,
                   torch.rand(3, 30, 1, generator=g), torch.ones(3, 30, 1), c, mgrid((10, 12)),
                   2, 1, weighted_value_and_grad_fn=sk.make_fused_weighted_value_and_grad(s2))
assert res.pred_scale.shape == (120, 1) and bool(torch.isfinite(res.losses).all())
erd = SirenERD(2, 16, 1, perturb=True, generator=g)
apply_fn, init_fn = plain_apply_init(erd, g)
fu = fit_until(apply_fn, 1e-3, init_fn, c, torch.rand(30, 1, generator=g), 0.0, 2,
               sk.make_fused_value_grad_absmax(erd))
assert fu.steps == 2 and len(fu.losses) == 2
from mri_super_resolution_tpu_torch.ops import mma_probe as mp
assert mp.mma_probe(torch.ones(4, 8, dtype=torch.int8), torch.ones(8, 8, dtype=torch.int8),
                    2, 3).shape == (2, 8)
assert not any(sk.LAUNCHES.values()) and not any(mp.LAUNCHES.values())
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
