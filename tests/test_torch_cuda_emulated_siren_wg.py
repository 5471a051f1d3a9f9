"""The CUDA source of the batched K1 on wgmma (``csrc/siren_wg.cu``, with
``csrc/tensor_core.cuh``'s TMA, mbarrier and MN-major wgmma pieces) runs on
the CPU under the emulation of the CUDA execution model
(``tests/cuda_emulation``: one fiber per CUDA thread; TMA box loads,
mbarriers and wgmma as the header computes them), through the same ctypes
launch code the wrapper uses on the card, against the plain batched K1 with
the TPU kernel's stash (``siren_loss_grads_batched_ref(..., stash="bf16")``).

Shapes are of the route's class (every width but the output a multiple of
128) and small: one slot and four, ragged row tiles (P not a multiple of
128), masked rows (``n_rows`` < P), a hidden layer of two column tiles, a
single hidden layer (no chain pass), dW split over many row ranges (one
128 x 128 tile splits its rows 10 ways at P = 300) and over ranges of two
stages with a ragged last one (P = 700 at 256-wide layers, D = 4: 11 splits
of 64 rows), weights that are a StackedAdam's slot-strided views, and two
calls for the same bits.

Tolerance: the loss within 1e-5 relative, each slot's dW/db within 5e-4 of
its largest magnitude. The kernel's forward and chain are bf16x3 products
(each operand within 2^-16 of its value) summed in another order than the
plain float32 version, so z differs by about 1e-6 relative; the stash rounds
sin(omega z) and cos(omega z) to bf16, and where the two versions' values
straddle a bf16 rounding boundary the stashed values part by one bf16 ulp
(2^-8 relative). Those few elements set the error: measured at most 2.8e-4
over these cases, against 5e-5 for the float32 stash's K1 in
``tests/test_torch_cuda_emulated_siren_tc.py``.

The same passes with the float32 stash (the unbatched K1, K3 and K2, held
against their plain versions case by case in
``tests/test_torch_cuda_emulated_siren_tc.py`` and ``..._tc_fwd.py``) are
held here to the grid: on two emulated SMs bit-equal to the 132-SM grid.
"""
import ctypes

import numpy as np
import pytest
import torch

from cuda_emulation.emulated import emulated_library
from mri_super_resolution_tpu_torch.ops import siren_kernel as tk

torch.set_num_threads(2)

WG_GRAD_TOL = 5e-4  # max |kernel - plain bf16 stash| / max |plain|, each slot's dW and db
WG_LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def emulated_wg(tmp_path_factory):
    return emulated_library(tmp_path_factory, "siren_wg", tk._wg_declare)


def _problem(dims, P, seed):
    """Seeded inputs at SIREN-init scale (``tests/test_torch_cuda_emulated_siren.py``'s)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    x = t(rng.uniform(-1, 1, size=(P, dims[0])))
    ws = []
    for l in range(len(dims) - 1):
        b = 1.0 / dims[l] if l == 0 else np.sqrt(6.0 / dims[l]) / 30
        ws.append(t(rng.uniform(-b, b, size=(dims[l + 1], dims[l]))))
        ws.append(t(rng.uniform(-1, 1, size=(dims[l + 1],)) / np.sqrt(dims[l])))
    return x, ws, t(rng.uniform(0, 1, size=(P, 1)))


def _stacked(dims, D, P, seed):
    """D stacked problems of :func:`_problem`'s scale on one x."""
    probs = [_problem(dims, P, seed + s) for s in range(D)]
    ws = [torch.stack([p[1][i] for p in probs]) for i in range(len(probs[0][1]))]
    return probs[0][0], ws, torch.stack([p[2] for p in probs])


@pytest.mark.parametrize("dims,D,P,n_rows,strided", [
    ((128, 128, 128, 1), 1, 300, 300, False),  # one slot, ragged rows, dW in 10 splits
    ((128, 128, 128, 1), 4, 300, 250, True),   # four slots, masked rows, a parameter buffer
    ((128, 256, 128, 1), 3, 200, 150, False),  # a hidden layer of two column tiles
    ((256, 128, 1), 2, 130, 129, False),       # one hidden layer: no chain pass
    ((128, 256, 256, 1), 4, 700, 700, False),  # dW splits of two stages, the last ragged
])
def test_emulated_wg_matches_plain_bf16_stash(emulated_wg, dims, D, P, n_rows, strided):
    """Every slot's loss, dW and db against the plain batched K1 with the
    TPU kernel's bf16 stash; two calls give the same bits."""
    from mri_super_resolution_tpu_torch.fit.optim import StackedAdam

    assert tk.tc_route(dims, ("sine",) * (len(dims) - 2) + ("none",))
    x, ws, target = _stacked(dims, D, P, seed=P + D)
    if strided:
        ws = StackedAdam(ws, 1e-4).params
        assert ws[0].stride(0) == sum(dims[l + 1] * (dims[l] + 1) for l in range(len(dims) - 1))
    omegas = [30.0] * (len(dims) - 2)
    loss, grads = tk._launch_loss_grads_wg(emulated_wg, x, ws, target, omegas, n_rows, 0)
    loss_r, grads_r = tk.siren_loss_grads_batched_ref(x, ws, target, omegas, n_rows,
                                                      stash="bf16")
    assert loss.shape == (D,)
    torch.testing.assert_close(loss, loss_r, rtol=WG_LOSS_RTOL, atol=0)
    for i, (a, b) in enumerate(zip(grads, grads_r)):
        assert a.shape == b.shape == ws[i].shape
        for s in range(D):
            err = float((a[s] - b[s]).abs().max()) / float(b[s].abs().max())
            assert err <= WG_GRAD_TOL, f"slot {s} grad {i}: {err:.3e}"
    if D == 4:  # a fixed-order reduction, no atomics: a second call gives the same bits
        loss2, grads2 = tk._launch_loss_grads_wg(emulated_wg, x, ws, target, omegas, n_rows, 0)
        assert torch.equal(loss, loss2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))


def test_emulated_wg_grid_does_not_set_the_numbers(emulated_wg, monkeypatch):
    """On two emulated SMs every persistent block walks many units (a
    pass's ring of stages runs on from one unit into the next, the staging
    of one unit's planes waits for the last unit's TMA stores), and dW's
    blocks take several splits. The numbers are those of the 132-SM grid,
    bit for bit: the work is planned for 132 SMs whatever the grid, and
    every sum runs in a fixed order."""
    dims, D, P = (128, 256, 128, 1), 4, 300
    x, ws, target = _stacked(dims, D, P, seed=7)
    wide = tk._launch_loss_grads_wg(emulated_wg, x, ws, target, 30.0, 290, 0)
    monkeypatch.setenv("EMU_SM_COUNT", "2")
    narrow = tk._launch_loss_grads_wg(emulated_wg, x, ws, target, 30.0, 290, 0)
    assert torch.equal(wide[0], narrow[0])
    assert all(torch.equal(a, b) for a, b in zip(wide[1], narrow[1]))
    ref = tk.siren_loss_grads_batched_ref(x, ws, target, 30.0, 290, stash="bf16")
    for a, b in zip(narrow[1], ref[1]):
        assert float((a - b).abs().max()) <= WG_GRAD_TOL * float(b.abs().max())


def test_emulated_wg_refuses_what_it_does_not_take(emulated_wg):
    """The workspace query (and with it the launch) refuses widths off the
    128 tile, no hidden layer, more than one output, a last hidden layer
    wider than 2,048 and D < 1; the launch code raises on them."""

    def nbytes(dims, P=100, D=1):
        arr = ctypes.cast((ctypes.c_int * len(dims))(*dims), ctypes.c_void_p)
        return emulated_wg.siren_wg_workspace_bytes(P, arr, len(dims) - 1, D)

    hybrid = nbytes((256, 512, 512, 512, 512, 1), 100_800, 4)
    # x's planes once, four slots' activation planes, F and two deltas' planes
    assert 6.3e9 < hybrid < 6.5e9, hybrid
    assert nbytes((128, 2048, 1)) > 0
    for dims in ((2, 128, 1), (128, 96, 1), (128, 1), (128, 128, 2), (64, 128, 128, 1),
                 (128, 2176, 1)):
        assert nbytes(dims) == -1, dims
    assert nbytes((128, 128, 1), D=0) == -1
    x, ws, target = _stacked((128, 96, 1), 2, 10, seed=0)
    with pytest.raises(ValueError, match="does not take"):
        tk._launch_loss_grads_wg(emulated_wg, x, ws, target, 30.0, 10, 0)


@pytest.mark.parametrize("kind", ["k1", "k3", "k2_dx", "k2_dw"])
def test_emulated_wg_f32_grid_does_not_set_the_numbers(emulated_wg, monkeypatch, kind):
    """The unbatched K1 (masked rows), K3 and K2 (dx alone; dW and dx) with
    the float32 stash on two emulated SMs, where each persistent block walks
    many units and dW's blocks several splits: the bits of the 132-SM grid,
    and within the bars of ``tests/test_torch_cuda_emulated_siren_tc.py``
    (5e-5 of each output's largest magnitude) of the plain versions."""
    dims, P = (128, 256, 128, 1), 300
    x, ws, target = _problem(dims, P, seed=11)
    g = target - 0.5
    omegas = [30.0] * (len(dims) - 2)
    run = {"k1": lambda: tk._launch_loss_grads_wg_f32(emulated_wg, x, ws, target, omegas, 290, 0),
           "k3": lambda: tk._launch_forward_wg(emulated_wg, x, ws, omegas, 0),
           "k2_dx": lambda: tk._launch_fused_bwd_wg(emulated_wg, x, ws, g, omegas, False, True, 0),
           "k2_dw": lambda: tk._launch_fused_bwd_wg(emulated_wg, x, ws, g, omegas, True, True, 0)}
    ref = {"k1": lambda: tk.siren_loss_grads_ref(x, ws, target, omegas, 290),
           "k3": lambda: tk.siren_forward_ref(x, ws, omegas),
           "k2_dx": lambda: tk.siren_fused_bwd_ref(x, ws, g, omegas, need_dw=False),
           "k2_dw": lambda: tk.siren_fused_bwd_ref(x, ws, g, omegas)}

    def flat(out):
        if isinstance(out, torch.Tensor):
            return [out]
        return [t for o in out if o is not None for t in flat(o)]

    wide = flat(run[kind]())
    monkeypatch.setenv("EMU_SM_COUNT", "2")
    narrow = flat(run[kind]())
    assert len(wide) == len(narrow) == {"k1": 7, "k3": 1, "k2_dx": 1, "k2_dw": 7}[kind]
    assert all(torch.equal(a, b) for a, b in zip(wide, narrow))
    for a, b in zip(narrow, flat(ref[kind]())):
        assert float((a - b).abs().max()) <= 5e-5 * float(b.abs().max())
