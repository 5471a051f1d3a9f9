"""The CUDA source of K1's tensor-core route (``csrc/siren_tc.cu``, with
``csrc/common.cuh`` and ``csrc/tensor_core.cuh``) runs on the CPU under an
emulation of the CUDA execution model (``tests/cuda_emulation``: one fiber
per CUDA thread; ``mma.sync``, ``ldmatrix`` and ``cp.async`` as the header
computes them), through the same ctypes launch code the wrapper uses on the
card, against the plain float32 version.

Shapes are of the route's class (every width but the output a multiple of
128) and small: ragged row tiles (P not a multiple of 128), masked rows
(``n_rows`` < P), a hidden layer of two column tiles (so the chain and dW
passes see non-square layers), a single hidden layer (no chain pass), and
dW split over many blocks' row ranges.

Tolerance: each dW/db within 5e-5 of its largest magnitude and the loss
within 1e-5 relative. The route's products are bf16x3 (hi hi + hi lo + lo
hi, each split within 2^-16 of its value) summed in float32 in another order
than the plain version; measured at most 6.3e-6 over these cases.
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
def emulated_tc(tmp_path_factory):
    return emulated_library(tmp_path_factory, "siren_tc", tk._tc_declare)


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
])
def test_emulated_tc_route_matches_plain(emulated_tc, dims, P, n_rows):
    assert tk.tc_route(dims, ("sine",) * (len(dims) - 2) + ("none",))
    x, ws, target = _problem(dims, P, seed=P + n_rows)
    omegas = [30.0] * (len(dims) - 2)
    loss, grads = tk._launch_loss_grads_tc(emulated_tc, x, ws, target, omegas, n_rows, 0)
    loss_r, grads_r = tk.siren_loss_grads_ref(x, ws, target, omegas, n_rows)
    torch.testing.assert_close(loss, loss_r, rtol=TC_LOSS_RTOL, atol=0)
    for i, (a, b) in enumerate(zip(grads, grads_r)):
        assert a.shape == b.shape
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= TC_GRAD_TOL, f"grad {i}: {err:.3e}"
    # a fixed-order reduction: a second run gives the same bits
    loss2, grads2 = tk._launch_loss_grads_tc(emulated_tc, x, ws, target, omegas, n_rows, 0)
    assert torch.equal(loss, loss2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))


def test_emulated_tc_refuses_widths_off_the_tile(emulated_tc):
    """The workspace query (and with it the launch) refuses widths that are
    not multiples of 128, no hidden layer, or more than one output."""
    import ctypes

    def nbytes(dims, P=100):
        arr = (ctypes.c_int * len(dims))(*dims)
        return emulated_tc.siren_tc_workspace_bytes(P, ctypes.cast(arr, ctypes.c_void_p),
                                                    len(dims) - 1)

    assert nbytes((256, 512, 512, 512, 512, 1), 70_000) > 4 * 70_000 * 512 * 10
    for dims in ((2, 128, 1), (128, 96, 1), (128, 1), (128, 128, 2), (64, 128, 128, 1)):
        assert nbytes(dims) == -1, dims
    x, ws, target = _problem((128, 96, 1), 10, seed=0)
    with pytest.raises(ValueError):
        tk._launch_loss_grads_tc(emulated_tc, x, ws, target, 30.0, 10, 0)
