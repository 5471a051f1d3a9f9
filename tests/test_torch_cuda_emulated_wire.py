"""The CUDA source of K4-K5 (``csrc/wire.cu``, with ``csrc/common.cuh``) runs
on the CPU under an emulation of the CUDA execution model
(``tests/cuda_emulation``), through the same ctypes launch code the wrapper
uses on the card, against the plain PyTorch versions: the 4-wide first
layer (depth below the GEMM's 8-deep stage), 0-2 hidden layers, widths off
the 128 tile, ragged and masked rows, and per-layer omega/sigma read from
the device array.
"""
import numpy as np
import pytest
import torch

from cuda_emulation.emulated import emulated_library
from mri_super_resolution_tpu_torch.ops import wire_kernel as wk

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def emulated_wire(tmp_path_factory):
    return emulated_library(tmp_path_factory, "wire", wk._declare)


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
