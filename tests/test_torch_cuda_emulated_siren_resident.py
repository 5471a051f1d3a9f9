"""The CUDA source of K1's weight-resident route (``csrc/siren_resident.cu``,
with ``csrc/common.cuh``) runs on the CPU under an emulation of the CUDA
execution model (``tests/cuda_emulation``: one fiber per CUDA thread, block
barriers, warp shuffles, shared memory filled with NaN bits at each block's
start), through the same ctypes launch code the wrapper uses on the card,
against the plain float32 version.

Cases: the 2-D ensemble's Siren 2 -> 64x7 -> 1 with sample weights (every
fifth 0), masked rows (``n_rows`` < P) and a ragged last tile; max |out|
with ReLU codes (the SirenERD trunk), with and without weights; widths that
are not multiples of 4; more row tiles than blocks (a block adds several
tiles into its slot); all weights 0. Widths the route does not take (K1-a's
2 -> 128x4 -> 128 -> 1, the flagship) are refused before any launch.

Tolerance: the SIMT route's (``tests/test_torch_cuda_emulated_siren.py``):
the loss within 1e-5 relative, each dW/db within 1e-4 relative and 1e-6
absolute; max |out| within 1e-6 relative. Both routes sum in float32 in
another order than the plain version.
"""
import ctypes

import numpy as np
import pytest
import torch

from cuda_emulation.emulated import emulated_library
from mri_super_resolution_tpu_torch.ops import siren_kernel as tk

torch.set_num_threads(2)

MASTER_DIMS = (2,) + (64,) * 7 + (1,)
ERD_ACTS = ("sine", "sine", "relu", "relu")
ERD_DIMS = (2, 24, 24, 20, 1)


@pytest.fixture(scope="module")
def emulated_res(tmp_path_factory):
    return emulated_library(tmp_path_factory, "siren_resident", tk._res_declare)


def _problem(dims, P, seed):
    """Seeded inputs at SIREN-init scale; sample weights in [0, 1] with
    every fifth 0."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    x = t(rng.uniform(-1, 1, size=(P, dims[0])))
    ws = []
    for l in range(len(dims) - 1):
        b = 1.0 / dims[l] if l == 0 else np.sqrt(6.0 / dims[l]) / 30
        ws.append(t(rng.uniform(-b, b, size=(dims[l + 1], dims[l]))))
        ws.append(t(rng.uniform(-1, 1, size=(dims[l + 1],)) / np.sqrt(dims[l])))
    sw = t(rng.uniform(0, 1, size=(P, 1)))
    sw[::5] = 0.0
    return x, ws, t(rng.uniform(0, 1, size=(P, 1))), sw


def _assert_k1(lib, x, ws, target, n_rows, sw=None, absmax=False, acts=None, omega=30.0):
    """The resident launch against the plain K1; returns the launch's result."""
    got = tk._launch_loss_grads_resident(lib, x, ws, target, omega, n_rows, 0, acts, sw,
                                         absmax)
    want = tk.siren_loss_grads_ref(x, ws, target, omega, n_rows, acts, sw, absmax)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    if absmax:
        torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
    assert len(got[-1]) == len(ws)
    for i, (a, b) in enumerate(zip(got[-1], want[-1])):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6, msg=f"grad {i}")
    return got


@pytest.mark.parametrize("P,n_rows,weighted", [
    (100, 100, True),  # weighted rows with zeros, a ragged last tile (100 = 3 x 32 + 4)
    (100, 77, True),  # masked rows
    (64, 64, False),  # unweighted, whole tiles
])
def test_emulated_resident_master_shape(emulated_res, P, n_rows, weighted):
    assert tk.resident_route(MASTER_DIMS)
    x, ws, target, sw = _problem(MASTER_DIMS, P, seed=P + n_rows)
    got = _assert_k1(emulated_res, x, ws, target, n_rows, sw if weighted else None)
    # the slots are summed in block order: a second call gives the same bits
    again = tk._launch_loss_grads_resident(emulated_res, x, ws, target, 30.0, n_rows, 0, None,
                                           sw if weighted else None)
    assert torch.equal(got[0], again[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], again[1]))


@pytest.mark.parametrize("weighted,n_rows", [(False, 137), (True, 120), (True, 137)])
def test_emulated_resident_absmax_relu(emulated_res, weighted, n_rows):
    """max |out| and ReLU codes (a SirenERD-like trunk whose output ReLU is
    on for about half the rows), with and without sample weights and masked
    rows; the row of the largest |out| is last, so a max over masked rows
    would show."""
    P = 137
    x, ws, target, sw = _problem(ERD_DIMS, P, seed=5)
    ws[6], ws[7] = ws[6] * 30.0, torch.zeros_like(ws[7])
    z = tk.siren_forward_ref(x, ws, 30.0, ERD_ACTS[:-1] + ("none",)).flatten()
    ws[7] = -z.median().reshape(1)
    out = tk.siren_forward_ref(x, ws, 30.0, ERD_ACTS).flatten()
    last = int(out.abs().argmax())
    order = [i for i in range(P) if i != last] + [last]
    x, target, sw = x[order].contiguous(), target[order].contiguous(), sw[order].contiguous()
    assert 0.2 < float((out > 0).float().mean()) < 0.8
    _assert_k1(emulated_res, x, ws, target, n_rows, sw if weighted else None, True, ERD_ACTS)


def test_emulated_resident_relu_step_is_zero_at_zero(emulated_res):
    """Pre-activations exactly 0: one unit of the ReLU layer with zero
    weights and bias, then the whole ReLU layer off (bias -100) and a last
    bias of 0, so the output is ReLU(0) everywhere. The step is 0 at z = 0,
    so that unit's and then every gradient are exactly 0, and so is max
    |out|."""
    P = 137
    x, ws, target, sw = _problem(ERD_DIMS, P, seed=5)
    ws[6] = ws[6] * 30.0
    ws[4][3].zero_()
    ws[5][3] = 0.0
    _, _, grads = _assert_k1(emulated_res, x, ws, target, P, sw, True, ERD_ACTS)
    assert float(grads[4][3].abs().max()) == 0.0 and float(grads[5][3]) == 0.0
    ws[5].fill_(-100.0)
    ws[7].zero_()
    loss, absmax, grads = _assert_k1(emulated_res, x, ws, target, P - 7, sw, True, ERD_ACTS)
    assert float(absmax) == 0.0 and float(loss) > 0
    assert all(float(g.abs().max()) == 0.0 for g in grads)


@pytest.mark.parametrize("dims,acts,P", [
    ((3, 10, 7, 1), ("sine", "sine", "none"), 45),  # widths off the multiple of 4
    ((3, 10, 7, 1), ("sine", "none", "none"), 45),
    ((5, 6, 1), ("relu", "relu"), 33),
])
def test_emulated_resident_odd_widths(emulated_res, dims, acts, P):
    """Widths off the multiple of 4, one omega per hidden layer."""
    x, ws, target, sw = _problem(dims, P, seed=sum(dims))
    omegas = [7.0 + 4.0 * l for l in range(len(dims) - 2)]
    _assert_k1(emulated_res, x, ws, target, P - 2, sw, True, acts, omega=omegas)


def test_emulated_resident_more_tiles_than_blocks(emulated_res):
    """4,300 rows are 135 tiles of 32 for 132 blocks: three blocks add a
    second tile into their slots."""
    x, ws, target, sw = _problem((2, 8, 1), 4300, seed=3)
    _assert_k1(emulated_res, x, ws, target, 4290, sw)


def test_emulated_resident_zero_weights(emulated_res):
    """All sample weights 0: the loss, every dW and db exactly 0."""
    x, ws, target, sw = _problem((2, 16, 16, 1), 50, seed=4)
    loss, grads = tk._launch_loss_grads_resident(emulated_res, x, ws, target, 30.0, 50, 0,
                                                 None, torch.zeros_like(sw))
    assert float(loss) == 0.0 and all(float(g.abs().max()) == 0.0 for g in grads)


def test_emulated_resident_plan_and_refusals(emulated_res):
    """The wrapper's shared-memory plan is the kernel's: across the edge of
    one block's shared memory the kernel's workspace query takes exactly the
    widths the route takes; it takes the 2-D ensemble's widths and refuses
    K1-a's and the flagship's, and a launch at those raises."""

    def work(dims, P):
        arr = (ctypes.c_int * len(dims))(*dims)
        return emulated_res.siren_resident_work_floats(P, ctypes.cast(arr, ctypes.c_void_p),
                                                       len(dims) - 1)

    for dims in (MASTER_DIMS, ERD_DIMS, (3, 10, 7, 1), (2, 8, 1), (64, 96, 130, 1),
                 (256, 512, 512, 512, 512, 1), (2, 1), (2, 8, 2), (2,) + (4,) * 17 + (1,),
                 *((2,) + (h,) * 7 + (1,) for h in range(70, 82)),
                 *((h, h, 1) for h in range(176, 186))):
        assert (work(dims, 100) >= 0) is tk.resident_route(dims), dims
    assert tk.resident_smem_bytes(MASTER_DIMS) == 189_328
    assert work(MASTER_DIMS, 3600) == 113 * (25_217 + 2)
    for dims in ((2,) + (128,) * 5 + (1,), (256, 512, 512, 512, 512, 1)):
        assert not tk.resident_route(dims)
        x, ws, target, _ = _problem(dims, 4, seed=0)
        with pytest.raises(ValueError):
            tk._launch_loss_grads_resident(emulated_res, x, ws, target, 30.0, 4, 0)
