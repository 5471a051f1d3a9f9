"""The CUDA source of K4's tensor-core route (``csrc/wire_tc.cu``, with
``csrc/common.cuh`` and ``csrc/tensor_core.cuh``) runs on the CPU under an
emulation of the CUDA execution model (``tests/cuda_emulation``: one fiber
per CUDA thread; ``mma.sync``, ``ldmatrix`` and ``cp.async`` as the header
computes them), through the same ctypes launch code the wrapper uses on the
card, against the plain float32 K4.

Shapes are of the route's class (H a multiple of 64) and small: H = 64 with
one and two hidden layers (2H = 128 and 4H = 256 fill one and two tiles),
ragged row tiles (P not a multiple of 128), masked rows (``n_rows`` < P),
per-layer omega in [5, 15] and sigma in [4, 10] read from the device array,
and the block gradient split over many blocks' row ranges.

Tolerance: the loss within 1e-5 relative and each dW/db within 3e-4 of its
largest magnitude. The route's products are bf16x3 (hi hi + hi lo + lo hi,
each split within 2^-16 of its value) summed in float32 in another order
than the plain version, its activations and dS are kept as hi/lo planes,
and the Gabor exponent moves by up to 2 sigma^2 |s| (about 40 at sigma = 10)
per unit of pre-activation error: against a float64 plain K4 the route's
dW/db are off by at most 1.0e-4 of their largest magnitude over these cases
(1.4e-5 with one hidden layer), the float32 plain K4's by at most 2.9e-6.
"""
import pytest
import torch

from cuda_emulation.emulated import emulated_library
from mri_super_resolution_tpu_torch.ops import wire_kernel as wk
# WIRE weights at init scale, per-layer omega in [5, 15] and sigma in [4, 10]
from test_torch_cuda_emulated_wire import _wire_problem

torch.set_num_threads(2)

TC_GRAD_TOL = 3e-4  # max |kernel - plain| / max |plain|, each dW and db
TC_LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def emulated_wire_tc(tmp_path_factory):
    return emulated_library(tmp_path_factory, "wire_tc", wk._tc_declare)


@pytest.mark.parametrize("nh,P,n_rows", [
    (2, 200, 200),  # two hidden layers, a ragged row tile
    (2, 200, 150),  # the same with masked rows
    (1, 130, 129),  # one hidden layer: the DX pass feeds the first layer at once
])
def test_emulated_wire_tc_matches_plain(emulated_wire_tc, nh, P, n_rows):
    assert wk.wire_tc_route(64, nh)
    x, ws, oms, target = _wire_problem(4, 64, nh, P, seed=P + n_rows + nh)
    loss, grads = wk._launch_loss_grads_tc(emulated_wire_tc, x, ws, oms, target, n_rows, 0)
    loss_r, grads_r = wk.wire_loss_grads_ref(x, ws, oms, target, n_rows)
    torch.testing.assert_close(loss, loss_r, rtol=TC_LOSS_RTOL, atol=0)
    assert len(grads) == len(grads_r) == len(ws)
    for i, (a, b) in enumerate(zip(grads, grads_r)):
        assert a.shape == b.shape
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= TC_GRAD_TOL, f"grad {i}: {err:.3e}"
    # every reduction in a fixed order: a second call gives the same bits
    loss2, grads2 = wk._launch_loss_grads_tc(emulated_wire_tc, x, ws, oms, target, n_rows, 0)
    assert torch.equal(loss, loss2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))


def test_emulated_wire_tc_route_and_workspace(emulated_wire_tc):
    """The route takes H = 256 (the reference) and multiples of 64 with a
    hidden layer, and refuses H = 100, H = 96 and no hidden layer, in the
    wrapper's rule and in the workspace query; the workspace holds the
    flagship's stashes."""
    assert wk.wire_tc_route(256, 2) and wk.wire_tc_route(64, 1) and wk.wire_tc_route(512, 2)
    for H, nh in ((100, 2), (96, 2), (256, 0), (32, 2)):
        assert not wk.wire_tc_route(H, nh)
        assert emulated_wire_tc.wire_tc_workspace_bytes(1000, 4, H, nh) == -1
    P, H = 70_000, 256
    n = emulated_wire_tc.wire_tc_workspace_bytes(P, 4, H, 2)
    # S0, two (P, 4H) stashes, two input planes and the float32 last output,
    # two dS plane buffers, all 4 bytes an element, and the block matrices
    stash = 4 * P * (2 * H + 2 * 4 * H + 3 * 2 * H + 2 * 4 * H)
    assert stash + 2 * 4 * 8 * H * H <= n <= stash + 64 * 2**20
    x, ws, oms, target = _wire_problem(4, 96, 1, 10, seed=0)
    with pytest.raises(ValueError):
        wk._launch_loss_grads_tc(emulated_wire_tc, x, ws, oms, target, 10, 0)
