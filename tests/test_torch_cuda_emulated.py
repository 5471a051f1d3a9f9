"""The CUDA sources of K1-K3 (``csrc/siren.cu``), K4-K5 (``csrc/wire.cu``)
and K6-K7 (``csrc/conv3d.cu``) run on the CPU under an
emulation of the CUDA execution model (``tests/cuda_emulation``: one
std::thread per CUDA thread, block barriers, warp shuffles), through the
same ctypes launch code the wrappers use on the card, against the plain
PyTorch versions. This checks the kernels' tiling, masking, split-K
reductions and buffer handling on the CPU; speed and the real compiler are
checked on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).

Shapes are tiny but cover ragged row tiles (P not a multiple of 128),
widths that are not multiples of the 128-wide tiles, several dW splits, a
masked row count and a single sine layer; for WIRE also the 4-wide first
layer (depth below the GEMM's 8-deep stage), 0-2 hidden layers and
per-layer omega/sigma read from the device array; for K6 SAME and VALID,
both types, outputs off the 16 x 32 tile, more than one channel chunk and
more than one 32-channel output block; for K7 the same, plus more than one
32-channel input block and more than one work item per workspace slot.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mri_super_resolution_tpu_torch.ops import _build
from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck
from mri_super_resolution_tpu_torch.ops import siren_kernel as tk
from mri_super_resolution_tpu_torch.ops import wire_kernel as wk

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))


def _emulated(tmp_path_factory, name: str, declare) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built with g++ against the emulation header."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (C++20) to build the CPU emulation")
    d = tmp_path_factory.mktemp(f"{name}_emu")
    src = d / "emu.cpp"
    src.write_text(f'#include "{os.path.join(HERE, "cuda_emulation", "cuda_runtime.h")}"\n'
                   f'#include "{_build.CSRC / f"{name}.cu"}"\n')
    out = d / f"lib{name}_emu.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-w",
                    "-I", os.path.join(HERE, "cuda_emulation"), "-o", str(out),
                    str(src), "-lpthread"], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    declare(lib)
    return lib


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    return _emulated(tmp_path_factory, "siren", tk._declare)


@pytest.fixture(scope="module")
def emulated_wire(tmp_path_factory):
    return _emulated(tmp_path_factory, "wire", wk._declare)


@pytest.fixture(scope="module")
def emulated_conv3d(tmp_path_factory):
    return _emulated(tmp_path_factory, "conv3d", ck._declare)


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


def _wire_problem(d, H, nh, P, seed):
    """WIRE weights at init scale (first layer U(+-1/d), complex weights
    N(0, 1/in)), per-layer omega in [5, 15] and sigma in [4, 10]."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    ws = []
    for _ in range(2):
        ws += [t(rng.uniform(-1 / d, 1 / d, size=(H, d))),
               t(rng.uniform(-1, 1, size=(H,)) / np.sqrt(d))]
    for _ in range(nh):
        for _ in range(2):
            ws += [t(rng.normal(size=(H, H)) / np.sqrt(H)) for _ in range(2)]
            ws += [t(rng.uniform(-1, 1, size=(H,)) / np.sqrt(H)) for _ in range(2)]
    ws += [t(rng.normal(size=(1, H)) / np.sqrt(H)) for _ in range(2)]
    ws += [t(rng.uniform(-1, 1, size=(1,)) / np.sqrt(H))]
    oms = t(np.stack([rng.uniform(5, 15, nh + 1), rng.uniform(4, 10, nh + 1)], 1))
    x = t(rng.uniform(-1, 1, size=(P, d)))
    return x, ws, oms, t(rng.uniform(0, 1, size=(P, 1)))


WIRE_CASES = [
    (4, 40, 2, 300, 300),  # 4H = 160 and 2H = 80 straddle the 128 tile, ragged rows
    (4, 136, 1, 137, 100),  # width over one tile, masked rows
    (2, 16, 0, 5, 3),  # no hidden layer, fewer rows than a warp
]


@pytest.mark.parametrize("d,H,nh,P,n_rows", WIRE_CASES)
def test_emulated_wire_kernels_match_plain(emulated_wire, d, H, nh, P, n_rows):
    x, ws, oms, target = _wire_problem(d, H, nh, P, seed=P)
    out = wk._launch_forward(emulated_wire, x, ws, oms, 0)
    torch.testing.assert_close(out, wk.wire_forward_ref(x, ws, oms), rtol=1e-5, atol=1e-6)
    loss, grads = wk._launch_loss_grads(emulated_wire, x, ws, oms, target, n_rows, 0)
    loss_r, grads_r = wk.wire_loss_grads_ref(x, ws, oms, target, n_rows)
    torch.testing.assert_close(loss, loss_r, rtol=1e-5, atol=0)
    assert len(grads) == len(grads_r) == len(ws)
    for i, (a, b) in enumerate(zip(grads, grads_r)):
        scale = float(b.abs().max()) + 1e-12
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * scale, msg=f"grad {i}")


def test_emulated_wire_workspace_is_enough(emulated_wire):
    """wire_work_floats covers every split plan of the 512x2 flagship."""
    n = emulated_wire.wire_work_floats(70_000, 4, 512, 2)
    # the 2048 x 1024 block gradient (128 output tiles) splits 70,000 rows in
    # 3; beside the partials: the block gradient, the bias gradient, delta
    assert n >= 3 * 2048 * 1024 + 8 * 512 * 512 + 4 * 512 + 70_000
    assert emulated_wire.wire_pack_floats(4, 256, 2) == (
        2 * 256 * 4 + 2 * 256 + 2 * (8 * 256 * 256 + 4 * 256) + 2 * 256)


CONV_CASES = [
    ((1, 5, 7, 4, 8), 8, "SAME"),  # one chunk, one group of 8 outputs, B 1
    ((2, 19, 35, 3, 16), 40, "VALID"),  # two row and two column tiles, two output blocks
    ((1, 17, 6, 5, 24), 16, "SAME"),  # three channel chunks, H over one tile
    ((1, 3, 3, 3, 8), 32, "VALID"),  # the smallest VALID input: one output voxel
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout,padding", CONV_CASES)
def test_emulated_conv3d_matches_plain(emulated_conv3d, shape, cout, padding, dtype):
    """float32: the sums' order differs, within 1e-5 of the largest output.
    bfloat16: bf16 operands, float32 sums, one rounding to nearest, so each
    output is within half a bf16 ulp of the float32 sum of the same operands
    (plus the sums' order)."""
    rng = np.random.default_rng(sum(shape) + cout)
    x = torch.as_tensor(rng.normal(size=shape).astype(np.float32)).to(dtype)
    k = torch.as_tensor((rng.normal(size=(3, 3, 3, shape[-1], cout)) * 0.1)
                        .astype(np.float32)).to(dtype)
    b = torch.as_tensor(rng.normal(size=(cout,)).astype(np.float32))
    out = ck._launch(emulated_conv3d, x, k, b, padding, 0)
    ref = ck.conv3d_rfab_ref(x, k, b, padding)
    assert out.shape == ref.shape and out.dtype == dtype
    sums = ck.conv3d_rfab_ref(x.float(), k.float(), b, padding)  # float32, unrounded
    scale = float(sums.abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * scale)
    else:
        half_ulp = 2.0 ** (torch.floor(torch.log2(sums.abs().clamp_min(1e-30))) - 8)
        assert bool(((out.float() - sums).abs() <= half_ulp + 1e-5 * scale).all())


BWD_CASES = [
    ((1, 5, 7, 4, 8), 8, "SAME"),  # one block, one slot per work item, B 1
    ((2, 19, 35, 3, 16), 40, "VALID"),  # ragged 8 x 16 items, two output blocks
    ((1, 9, 18, 5, 40), 16, "SAME"),  # two input-channel blocks (32 + 8)
    ((4, 17, 17, 12, 8), 8, "SAME"),  # 288 work items: two per workspace slot
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout,padding", BWD_CASES)
def test_emulated_conv3d_bwd_matches_plain(emulated_conv3d, shape, cout, padding, dtype):
    """K7 against its plain version. dW and db (float32 sums of the same
    float32 products in another order) within 1e-5 of their largest entry;
    dx as K6's output: float32 within 1e-5 of the largest, bfloat16 within
    half a bf16 ulp of the float32 sum of the same operands."""
    rng = np.random.default_rng(sum(shape) + cout)
    x = torch.as_tensor(rng.normal(size=shape).astype(np.float32)).to(dtype)
    k = torch.as_tensor((rng.normal(size=(3, 3, 3, shape[-1], cout)) * 0.1)
                        .astype(np.float32)).to(dtype)
    g = torch.as_tensor(rng.normal(size=(*ck.out_shape(shape, padding), cout))
                        .astype(np.float32)).to(dtype)
    dx, dw, db = ck._launch_bwd(emulated_conv3d, x, k, g, padding, 0)
    dx_r, dw_r, db_r = ck.conv3d_rfab_bwd_ref(x, k, g, padding)
    assert dx.shape == x.shape and dx.dtype == dtype
    assert dw.shape == (3, 3, 3, shape[-1], cout) and db.shape == (cout,)
    for a, b in ((dw, dw_r), (db, db_r)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))
    sums = ck.conv3d_rfab_bwd_ref(x.float(), k.float(), g.float(), padding)[0]
    scale = float(sums.abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(dx, dx_r, rtol=0, atol=1e-5 * scale)
    else:
        half_ulp = 2.0 ** (torch.floor(torch.log2(sums.abs().clamp_min(1e-30))) - 8)
        assert bool(((dx.float() - sums).abs() <= half_ulp + 1e-5 * scale).all())


def test_emulated_conv3d_bwd_repeats_and_sizes_its_workspace(emulated_conv3d):
    """Two runs give the same bits (no atomics); the slot count is at most
    two waves of 132 blocks and refuses a workspace sized for another call."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(4, 17, 17, 12, 8)).astype(np.float32))
    k = torch.as_tensor(rng.normal(size=(3, 3, 3, 8, 8)).astype(np.float32))
    g = torch.as_tensor(rng.normal(size=(4, 17, 17, 12, 8)).astype(np.float32))
    a = ck._launch_bwd(emulated_conv3d, x, k, g, "SAME", 0)
    b = ck._launch_bwd(emulated_conv3d, x, k, g, "SAME", 0)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    # the training path's main call: 32 x 9 planes of 5 x 3 items in 255 slots
    assert emulated_conv3d.conv3d_rfab_bwd_slots(32, 34, 34, 9, 1) == 255
    assert emulated_conv3d.conv3d_rfab_bwd_slots(4, 17, 17, 12, 1) == 144
    rc = emulated_conv3d.conv3d_rfab_bwd_f32(
        x.data_ptr(), 4, 17, 17, 12, 8, k.data_ptr(), g.data_ptr(), 8, 1, x.data_ptr(),
        k.data_ptr(), g.data_ptr(), g.data_ptr(), 7, 0)
    assert rc == -1
