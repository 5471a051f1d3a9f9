"""The CUDA source of K3's and K2's tensor-core route (``csrc/siren_wg.cu``'s
``siren_forward_wg`` and ``siren_fused_bwd_wg``, with ``csrc/gemm3.cuh``'s
splits and ``csrc/tensor_core.cuh``'s TMA, mbarrier and wgmma pieces) runs
on the CPU under an emulation of the CUDA execution model
(``tests/cuda_emulation``: one fiber per CUDA thread; TMA box loads and
stores, mbarriers and wgmma as the header computes them), through the same
ctypes launch code the wrapper uses on the card, against the plain float32
versions.

Shapes are of the route's class (every width but the output a multiple of
128) and small: ragged row tiles (P not a multiple of 128) with two hidden
layers (K2's chain pass), three hidden layers with two column tiles (each of
the forward's two activation slots, or K2's two delta buffers without dW,
read by one layer and written by the next, where a slot read and written
by the same layer would show), a hidden layer of two column tiles
(non-square chain, dx and dW passes), and a single hidden layer (K2 has no
chain pass: dx comes from the first delta, made by the last layer's
kernel); K2 with and without dW (without, the activations ping-pong in the
delta buffers, and the chain sums no db).

Tolerance: K3's output, dx and each dW/db within 5e-5 of their largest
magnitude, as ``tests/test_torch_cuda_emulated_siren_tc.py`` holds K1. The
route's products are bf16x3 (hi hi + hi lo + lo hi, each split within 2^-16
of its value) summed in float32 in another order than the plain version;
measured at most 5.0e-6 (K3) and 1.2e-5 (K2, dx and dW) over these cases.
"""
import ctypes

import numpy as np
import pytest
import torch

from cuda_emulation.emulated import emulated_library
from mri_super_resolution_tpu_torch.ops import siren_kernel as tk

torch.set_num_threads(2)

TC_TOL = 5e-5  # max |kernel - plain| / max |plain|: K3's output, dx, each dW and db

SHAPES = [
    ((128, 128, 128, 1), 300),  # two hidden layers, ragged rows
    ((128, 256, 256, 128, 1), 140),  # three: every ping-pong slot read and written
    ((128, 256, 128, 1), 200),  # a hidden layer of two column tiles
    ((256, 128, 1), 130),       # one hidden layer: no chain pass
]


@pytest.fixture(scope="module")
def emulated_wg(tmp_path_factory):
    return emulated_library(tmp_path_factory, "siren_wg", tk._wg_declare)


def _problem(dims, P, seed):
    """Seeded inputs at SIREN-init scale and an upstream gradient g (P, 1)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    x = t(rng.uniform(-1, 1, size=(P, dims[0])))
    ws = []
    for l in range(len(dims) - 1):
        b = 1.0 / dims[l] if l == 0 else np.sqrt(6.0 / dims[l]) / 30
        ws.append(t(rng.uniform(-b, b, size=(dims[l + 1], dims[l]))))
        ws.append(t(rng.uniform(-1, 1, size=(dims[l + 1],)) / np.sqrt(dims[l])))
    return x, ws, t(rng.normal(size=(P, 1)) / P)


def _rel(a, b) -> float:
    assert a.shape == b.shape
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.parametrize("dims,P", SHAPES)
def test_emulated_k3_matches_plain(emulated_wg, dims, P):
    assert tk.tc_route(dims, ("sine",) * (len(dims) - 2) + ("none",))
    x, ws, _ = _problem(dims, P, seed=P)
    omegas = [30.0] * (len(dims) - 2)
    out = tk._launch_forward_wg(emulated_wg, x, ws, omegas, 0)
    err = _rel(out, tk.siren_forward_ref(x, ws, omegas))
    assert err <= TC_TOL, f"K3: {err:.3e}"
    # fixed-order sums of the row dots: a second run gives the same bits
    assert torch.equal(out, tk._launch_forward_wg(emulated_wg, x, ws, omegas, 0))


@pytest.mark.parametrize("need_dw", [False, True])
@pytest.mark.parametrize("dims,P", SHAPES)
def test_emulated_k2_matches_plain(emulated_wg, dims, P, need_dw):
    x, ws, g = _problem(dims, P, seed=P + 1)
    omegas = [30.0] * (len(dims) - 2)
    dx, grads = tk._launch_fused_bwd_wg(emulated_wg, x, ws, g, omegas, need_dw, True, 0)
    dx_r, grads_r = tk.siren_fused_bwd_ref(x, ws, g, omegas, need_dw=need_dw)
    assert (grads is None) is (not need_dw)
    for i, (a, b) in enumerate(zip([dx, *(grads or [])], [dx_r, *(grads_r or [])])):
        err = _rel(a, b)
        assert err <= TC_TOL, f"{'dx' if i == 0 else f'grad {i - 1}'}: {err:.3e}"
    # fixed-order reductions: a second run gives the same bits
    dx2, grads2 = tk._launch_fused_bwd_wg(emulated_wg, x, ws, g, omegas, need_dw, True, 0)
    assert torch.equal(dx, dx2)
    assert not need_dw or all(torch.equal(a, b) for a, b in zip(grads, grads2))


def test_emulated_k2_dw_without_dx(emulated_wg):
    """dW alone (the DX pass skipped) gives the same bits as with dx."""
    dims, P = SHAPES[0]
    x, ws, g = _problem(dims, P, seed=5)
    dx, grads = tk._launch_fused_bwd_wg(emulated_wg, x, ws, g, 30.0, True, False, 0)
    _, grads_dx = tk._launch_fused_bwd_wg(emulated_wg, x, ws, g, 30.0, True, True, 0)
    assert dx is None and all(torch.equal(a, b) for a, b in zip(grads, grads_dx))


def test_emulated_workspaces(emulated_wg):
    """The size queries refuse widths off the tile, as K1's does; K3 keeps
    two activation slots and no F, K2 without dW no activation of its own:
    each needs less than K1 at the flagship; K2 with dW carves K1's plan."""
    def arr(dims):
        return ctypes.cast((ctypes.c_int * len(dims))(*dims), ctypes.c_void_p)

    lib = emulated_wg
    flag, P = (256, 512, 512, 512, 512, 1), 70_000
    k1 = lib.siren_loss_grads_wg_f32_workspace_bytes(P, arr(flag), 5)
    k3 = lib.siren_forward_wg_workspace_bytes(P, arr(flag), 5)
    k2_dx = lib.siren_fused_bwd_wg_workspace_bytes(P, arr(flag), 5, 0)
    k2_dw = lib.siren_fused_bwd_wg_workspace_bytes(P, arr(flag), 5, 1)
    # K3: x's planes, two slots of (P, 512), the weights' planes
    assert 4 * P * (256 + 2 * 512) <= k3 < 4 * P * (256 + 2 * 512) + 8 * 2 ** 20
    # K2 dx only: x, four F and two deltas of (P, 512)
    assert 4 * P * (256 + 6 * 512) <= k2_dx < 4 * P * (256 + 6 * 512) + 8 * 2 ** 20
    assert k3 < k2_dx < k2_dw == k1
    for dims in ((2, 128, 1), (128, 96, 1), (128, 1), (128, 128, 2), (64, 128, 128, 1)):
        assert lib.siren_forward_wg_workspace_bytes(100, arr(dims), len(dims) - 1) == -1
        for need_dw in (0, 1):
            assert lib.siren_fused_bwd_wg_workspace_bytes(100, arr(dims), len(dims) - 1,
                                                          need_dw) == -1
    x, ws, g = _problem((128, 96, 1), 10, seed=0)
    with pytest.raises(ValueError):
        tk._launch_forward_wg(lib, x, ws, 30.0, 0)
    with pytest.raises(ValueError):
        tk._launch_fused_bwd_wg(lib, x, ws, g, 30.0, False, True, 0)
