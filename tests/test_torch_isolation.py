"""The port imports neither JAX nor the JAX package: every module of it
imports, and short CPU fits of the SIREN and WIRE paths and a tiny MISR run
(the K6 route, its plain version on the CPU) run, in a process where both
are blocked."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "flax", "optax", "mri_super_resolution_tpu"):
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
assert not any(k == "jax" or k.startswith(("jax.", "flax", "optax", "mri_super_resolution_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("OK", len(mods))
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                          text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")
    assert int(proc.stdout.split()[1]) >= 20  # every module was imported


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
