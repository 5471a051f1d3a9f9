"""The CUDA source of K1's tensor-core route (``csrc/siren_wg.cu``'s
``siren_loss_grads_wg_f32``, with ``csrc/gemm3.cuh``'s splits and
``csrc/tensor_core.cuh``'s TMA, mbarrier and wgmma pieces) runs on the CPU
under an emulation of the CUDA execution model (``tests/cuda_emulation``:
one fiber per CUDA thread; TMA box loads and stores, mbarriers and wgmma as
the header computes them), through the same ctypes launch code the wrapper
uses on the card, against the plain float32 version.

Shapes are of the route's class (every width but the output a multiple of
128) and small: ragged row tiles (P not a multiple of 128), masked rows
(``n_rows`` < P), a hidden layer of two column tiles (so the chain and dW
passes see non-square layers), three hidden layers (each of the two delta
buffers written by one chain pass and read by the next), a single hidden
layer (no chain pass), and dW split over many blocks' row ranges.

Tolerance: each dW/db within 5e-5 of its largest magnitude and the loss
within 1e-5 relative. The route keeps the float32 stash (each layer's input
as hi/lo planes, dW bf16x3 in three products, the sine's factor in
float32), so its products are bf16x3 (hi hi + hi lo + lo hi, each split
within 2^-16 of its value) summed in float32 in another order than the
plain version; measured at most 9.0e-6 over these cases.

The batched cases hold the batched K1 of this class of shapes (the same
passes with the Pallas K1's bf16 stash) against the unbatched entry here,
slot by slot.
"""
import numpy as np
import pytest
import torch

from cuda_emulation.emulated import emulated_library
from mri_super_resolution_tpu_torch.ops import siren_kernel as tk

torch.set_num_threads(2)

TC_GRAD_TOL = 5e-5  # max |kernel - plain| / max |plain|, each dW and db
TC_LOSS_RTOL = 1e-5


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


@pytest.mark.parametrize("dims,P,n_rows", [
    ((128, 128, 128, 1), 300, 300),  # two hidden layers, ragged rows
    ((128, 128, 128, 1), 300, 250),  # the same with masked rows
    ((128, 256, 128, 1), 200, 150),  # a hidden layer of two column tiles, masked
    ((256, 128, 1), 130, 129),       # one hidden layer: no chain pass
    ((128, 256, 128, 256, 1), 140, 140),  # three: each delta buffer written, then read
])
def test_emulated_tc_route_matches_plain(emulated_wg, dims, P, n_rows):
    assert tk.tc_route(dims, ("sine",) * (len(dims) - 2) + ("none",))
    x, ws, target = _problem(dims, P, seed=P + n_rows)
    omegas = [30.0] * (len(dims) - 2)
    loss, grads = tk._launch_loss_grads_wg_f32(emulated_wg, x, ws, target, omegas, n_rows, 0)
    loss_r, grads_r = tk.siren_loss_grads_ref(x, ws, target, omegas, n_rows)
    torch.testing.assert_close(loss, loss_r, rtol=TC_LOSS_RTOL, atol=0)
    for i, (a, b) in enumerate(zip(grads, grads_r)):
        assert a.shape == b.shape
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= TC_GRAD_TOL, f"grad {i}: {err:.3e}"
    # a fixed-order reduction: a second run gives the same bits
    loss2, grads2 = tk._launch_loss_grads_wg_f32(emulated_wg, x, ws, target, omegas, n_rows, 0)
    assert torch.equal(loss, loss2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))


def test_emulated_tc_refuses_widths_off_the_tile(emulated_wg):
    """The workspace query (and with it the launch) refuses widths that are
    not multiples of 128, no hidden layer, or more than one output."""
    import ctypes

    def nbytes(dims, P=100):
        arr = (ctypes.c_int * len(dims))(*dims)
        return emulated_wg.siren_loss_grads_wg_f32_workspace_bytes(
            P, ctypes.cast(arr, ctypes.c_void_p), len(dims) - 1)

    assert nbytes((256, 512, 512, 512, 512, 1), 70_000) > 4 * 70_000 * 512 * 10
    for dims in ((2, 128, 1), (128, 96, 1), (128, 1), (128, 128, 2), (64, 128, 128, 1)):
        assert nbytes(dims) == -1, dims
    x, ws, target = _problem((128, 96, 1), 10, seed=0)
    with pytest.raises(ValueError):
        tk._launch_loss_grads_wg_f32(emulated_wg, x, ws, target, 30.0, 10, 0)


def _stacked(dims, D, P, seed):
    """D stacked problems of :func:`_problem`'s scale on one x."""
    probs = [_problem(dims, P, seed + s) for s in range(D)]
    x = probs[0][0]
    ws = [torch.stack([p[1][i] for p in probs]) for i in range(len(probs[0][1]))]
    return x, ws, torch.stack([p[2] for p in probs])


@pytest.mark.parametrize("dims,D,P,n_rows,strided", [
    ((128, 128, 128, 1), 1, 300, 300, False),  # one slot, ragged rows
    ((128, 128, 128, 1), 4, 300, 250, True),   # four slots, masked rows, a parameter buffer
    ((128, 256, 128, 1), 3, 200, 150, False),  # a hidden layer of two column tiles
])
def test_emulated_tc_batched_matches_plain_and_unbatched(emulated_wg, dims, D, P, n_rows,
                                                         strided):
    """The batched K1 of the tensor-core class (every slot's passes in one
    launch, the Pallas K1's bf16 stash) against the plain batched K1 with
    that stash at its file's tolerances
    (``tests/test_torch_cuda_emulated_siren_wg.py``), and each slot against
    the unbatched tensor-core K1 (the same passes at one slot with the
    float32 stash) on its inputs: the two part by at most what the two
    stashes' plain versions part by, plus each one's own tolerance. ``strided``: the weights are views of
    one (D, n_params) buffer, a StackedAdam's, so each slot's tensors lie
    n_params floats apart."""
    from mri_super_resolution_tpu_torch.fit.optim import StackedAdam
    from test_torch_cuda_emulated_siren_wg import WG_GRAD_TOL, WG_LOSS_RTOL

    x, ws, target = _stacked(dims, D, P, seed=P + D)
    if strided:
        ws = StackedAdam(ws, 1e-4).params
        assert ws[0].stride(0) == sum(dims[l + 1] * (dims[l] + 1) for l in range(len(dims) - 1))
    omegas = [30.0] * (len(dims) - 2)
    loss, grads = tk._launch_loss_grads_wg(emulated_wg, x, ws, target, omegas, n_rows, 0)
    loss_r, grads_r = tk.siren_loss_grads_batched_ref(x, ws, target, omegas, n_rows,
                                                      stash="bf16")
    _, grads_f = tk.siren_loss_grads_batched_ref(x, ws, target, omegas, n_rows)
    assert loss.shape == (D,)
    torch.testing.assert_close(loss, loss_r, rtol=WG_LOSS_RTOL, atol=0)
    for i, (a, b) in enumerate(zip(grads, grads_r)):
        assert a.shape == b.shape == ws[i].shape
        for s in range(D):
            err = float((a[s] - b[s]).abs().max()) / float(b[s].abs().max())
            assert err <= WG_GRAD_TOL, f"slot {s} grad {i}: {err:.3e}"
    rel = lambda a, b: float((a - b).abs().max()) / float(b.abs().max())
    for s in range(D):
        l1, g1 = tk._launch_loss_grads_wg_f32(emulated_wg, x, [w[s].contiguous() for w in ws],
                                              target[s].contiguous(), omegas, n_rows, 0)
        torch.testing.assert_close(loss[s], l1, rtol=WG_LOSS_RTOL + TC_LOSS_RTOL, atol=0)
        for i, (a, b) in enumerate(zip(grads, g1)):
            bar = rel(grads_r[i][s], grads_f[i][s]) + WG_GRAD_TOL + TC_GRAD_TOL
            assert rel(a[s], b) <= bar, f"slot {s} grad {i}: {rel(a[s], b):.3e} > {bar:.3e}"


def test_emulated_tc_batched_workspace(emulated_wg):
    """The batched K1's workspace at the hybrid's shape: x's planes once,
    and a slot's activation planes (hi and lo, the last hidden layer's hi
    alone), its factors in bf16 and two deltas' planes, 1.58 GB a slot at D
    = 4, against 2.14 GB for the float32 stash of the unbatched tensor-core
    K1 (every activation's hi and lo planes, the factors in float32); widths
    off the tile and D < 1 are refused."""
    import ctypes

    def nbytes(dims, P, D=None):
        arr = ctypes.cast((ctypes.c_int * len(dims))(*dims), ctypes.c_void_p)
        if D is None:
            return emulated_wg.siren_loss_grads_wg_f32_workspace_bytes(P, arr, len(dims) - 1)
        return emulated_wg.siren_wg_workspace_bytes(P, arr, len(dims) - 1, D)

    flag, P = (256, 512, 512, 512, 512, 1), 100_800
    x_bytes = (4 * P * 256 + 255) // 256 * 256
    one = nbytes(flag, P) - x_bytes  # the unbatched K1's pieces but x's
    assert 2.0e9 < one < 2.2e9
    four = nbytes(flag, P, 4)
    assert 1.55e9 < (four - x_bytes) / 4 < 1.62e9
    assert nbytes(flag, P, 1) < nbytes(flag, P, 2) < four
    assert nbytes((128, 96, 1), 10, 2) == -1 and nbytes(flag, P, 0) == -1
