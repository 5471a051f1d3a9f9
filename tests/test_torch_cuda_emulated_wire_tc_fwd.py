"""K5 on the tensor-core route of ``csrc/wire_tc.cu`` (``wire_forward_tc``:
K4's forward passes alone, without the pre-activation stash, two
alternating activation slots and a forward-only last layer) runs on the CPU
under the CUDA emulation of ``tests/cuda_emulation``, through the same
ctypes launch code the wrapper uses on the card, against the plain float32
K5.

Shapes: H = 64 with one and two hidden layers, ragged row tiles (P not a
multiple of 128), per-layer omega in [5, 15] and sigma in [4, 10] read from
the device array.

Tolerance: ``chip_smoke.py``'s K5 bar, max |kernel - plain| within 1e-4 of
max |plain|: bf16x3 products (each operand split within 2^-16 of its
value) summed in float32 in another order, the activations kept as hi/lo
planes between layers.
"""
import pytest
import torch

from cuda_emulation.emulated import emulated_library
from mri_super_resolution_tpu_torch.ops import wire_kernel as wk
# WIRE weights at init scale, per-layer omega in [5, 15] and sigma in [4, 10]
from test_torch_cuda_emulated_wire import _wire_problem

torch.set_num_threads(2)

K5_TOL = 1e-4  # max |kernel - plain| / max |plain|


@pytest.fixture(scope="module")
def emulated_wire_tc(tmp_path_factory):
    return emulated_library(tmp_path_factory, "wire_tc", wk._tc_declare)


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.parametrize("nh,P", [(2, 200), (1, 130), (2, 37)])
def test_emulated_wire_forward_tc_matches_plain(emulated_wire_tc, nh, P):
    """Ragged row tiles (and fewer rows than one tile); a second call gives
    the same bits."""
    assert wk.wire_tc_route(64, nh)
    x, ws, oms, _ = _wire_problem(4, 64, nh, P, seed=P + nh)
    out = wk._launch_forward_tc(emulated_wire_tc, x, ws, oms, 0)
    ref = wk.wire_forward_ref(x, ws, oms)
    assert out.shape == ref.shape == (P, 1)
    assert _rel(out, ref) <= K5_TOL, f"{_rel(out, ref):.3e}"
    assert torch.equal(out, wk._launch_forward_tc(emulated_wire_tc, x, ws, oms, 0))


def test_emulated_wire_forward_tc_reads_omegas(emulated_wire_tc):
    """omega and sigma come from the omegas array on each call (trained
    values, not the init's): other values give the plain version's other
    output."""
    x, ws, oms, _ = _wire_problem(4, 64, 2, 150, seed=3)
    for scale in (1.0, 0.8):
        o = (oms * scale).contiguous()
        out = wk._launch_forward_tc(emulated_wire_tc, x, ws, o, 0)
        assert _rel(out, wk.wire_forward_ref(x, ws, o)) <= K5_TOL
    assert _rel(wk.wire_forward_ref(x, ws, oms * 0.8), wk.wire_forward_ref(x, ws, oms)) > 1e-2


def test_emulated_wire_forward_tc_workspace(emulated_wire_tc):
    """The forward's workspace holds two activation slots and the block
    matrices, no stash; widths off the route are refused."""
    for H, nh in ((100, 2), (96, 2), (256, 0), (32, 2)):
        assert emulated_wire_tc.wire_forward_tc_workspace_bytes(1000, 4, H, nh) == -1
    P, H = 262_144, 256
    n = emulated_wire_tc.wire_forward_tc_workspace_bytes(P, 4, H, 2)
    slots = 2 * 4 * P * 2 * H
    assert slots + 2 * 4 * 8 * H * H <= n <= slots + 2 * 4 * 8 * H * H + 2**16
    assert n < emulated_wire_tc.wire_tc_workspace_bytes(P, 4, H, 2) / 4
    x, ws, oms, _ = _wire_problem(4, 96, 1, 10, seed=0)
    with pytest.raises(ValueError):
        wk._launch_forward_tc(emulated_wire_tc, x, ws, oms, 0)
