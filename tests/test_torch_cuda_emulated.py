"""The CUDA source of K1-K3 (``csrc/siren.cu``) run on the CPU under an
emulation of the CUDA execution model (``tests/cuda_emulation``: one
std::thread per CUDA thread, block barriers, warp shuffles), through the
same ctypes launch code the wrappers use on the card, against the plain
PyTorch versions. This checks the kernels' tiling, masking, split-K
reductions and buffer handling on the CPU; speed and the real compiler are
checked on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).

Shapes are tiny but cover ragged row tiles (P not a multiple of 128),
widths that are not multiples of the 128-wide tiles, several dW splits, a
masked row count and a single sine layer.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mri_super_resolution_tpu_torch.ops import _build
from mri_super_resolution_tpu_torch.ops import siren_kernel as tk

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (C++20) to build the CPU emulation")
    d = tmp_path_factory.mktemp("siren_emu")
    src = d / "emu.cpp"
    src.write_text(f'#include "{os.path.join(HERE, "cuda_emulation", "cuda_runtime.h")}"\n'
                   f'#include "{_build.CSRC / "siren.cu"}"\n')
    out = d / "libsiren_emu.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-w",
                    "-I", os.path.join(HERE, "cuda_emulation"), "-o", str(out),
                    str(src), "-lpthread"], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    tk._declare(lib)
    return lib


def _problem(dims, P, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    x = t(rng.uniform(-1, 1, size=(P, dims[0])))
    ws = []
    for l in range(len(dims) - 1):
        b = 1.0 / dims[l] if l == 0 else np.sqrt(6.0 / dims[l]) / 30
        ws.append(t(rng.uniform(-b, b, size=(dims[l + 1], dims[l]))))
        ws.append(t(rng.uniform(-1, 1, size=(dims[l + 1],)) / np.sqrt(dims[l])))
    return x, ws, t(rng.uniform(0, 1, size=(P, 1))), t(rng.normal(size=(P, 1)))


CASES = [
    ((16, 40, 40, 1), 300, 300),  # two hidden sine layers, ragged rows
    ((24, 136, 130, 1), 137, 100),  # widths over one 128 tile, masked rows
    ((8, 16, 1), 5, 3),  # one sine layer, fewer rows than a warp
]


@pytest.mark.parametrize("dims,P,n_rows", CASES)
def test_emulated_kernels_match_plain(emulated_lib, dims, P, n_rows):
    x, ws, target, g = _problem(dims, P, seed=P)
    omegas = [30.0] * (len(dims) - 2)
    torch.testing.assert_close(tk._launch_forward(emulated_lib, x, ws, omegas, 0),
                               tk.siren_forward_ref(x, ws, omegas), rtol=1e-5, atol=1e-6)
    loss, grads = tk._launch_loss_grads(emulated_lib, x, ws, target, omegas, n_rows, 0)
    loss_r, grads_r = tk.siren_loss_grads_ref(x, ws, target, omegas, n_rows)
    torch.testing.assert_close(loss, loss_r, rtol=1e-5, atol=0)
    for a, b in zip(grads, grads_r):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    dx, dws = tk._launch_fused_bwd(emulated_lib, x, ws, g, omegas, True, True, 0)
    dx_r, dws_r = tk.siren_fused_bwd_ref(x, ws, g, omegas)
    torch.testing.assert_close(dx, dx_r, rtol=1e-4, atol=1e-5)
    for a, b in zip(dws, dws_r):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    dx2, none = tk._launch_fused_bwd(emulated_lib, x, ws, g, omegas, False, True, 0)
    assert none is None
    torch.testing.assert_close(dx2, dx, rtol=0, atol=0)


def test_emulated_partial_workspace_is_enough(emulated_lib):
    """siren_partial_floats covers every split plan of the flagship shapes."""
    dims = (256, 512, 512, 512, 512, 1)
    arr = (ctypes.c_int * len(dims))(*dims)
    n = emulated_lib.siren_partial_floats(70_000, ctypes.cast(arr, ctypes.c_void_p),
                                          len(dims) - 1)
    # dW of a 512 x 512 layer over 70,000 rows splits into 17 partials
    assert n >= 17 * 512 * 512
