"""The port imports neither JAX nor the JAX package: every module of it
imports, and a short CPU fit runs, in a process where both are blocked."""
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
