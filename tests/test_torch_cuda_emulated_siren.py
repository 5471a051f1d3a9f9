"""The CUDA source of K1-K3 (``csrc/siren.cu``, with ``csrc/common.cuh``) runs
on the CPU under an emulation of the CUDA execution model
(``tests/cuda_emulation``: one fiber per CUDA thread, block barriers, warp
shuffles), through the same ctypes launch code the wrapper uses on the card,
against the plain PyTorch versions. This checks the kernels' tiling,
masking, split-K reductions and buffer handling on the CPU; speed and the
real compiler are checked on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).

Shapes are tiny but cover ragged row tiles (P not a multiple of 128),
widths that are not multiples of the 128-wide tiles, several dW splits, a
masked row count and a single sine layer; for K1's variants ReLU codes (the
SirenERD trunk), sample weights with zeros, max |out| over ragged rows, and
pre-activations exactly 0 (ReLU's step is 0 there); and the K1 calls of the
widths no other route takes (:func:`k1_route`): widths off a multiple of 4
with an omega per hidden layer, one hidden layer, 4,300 rows, all sample
weights 0.
"""
import ctypes

import numpy as np
import pytest
import torch

from cuda_emulation.emulated import emulated_library
from mri_super_resolution_tpu_torch.ops import siren_kernel as tk

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    return emulated_library(tmp_path_factory, "siren", tk._declare)


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


ERD_ACTS = ("sine", "sine", "relu", "relu")
ERD_DIMS = (2, 24, 24, 20, 1)


def _erd_problem(P, seed):
    """A SirenERD-like trunk (two sine layers, a ReLU layer, a ReLU output)
    at SIREN-init scale but for the output layer, widened and shifted so
    that its pre-activations take both signs; sample weights in [0, 1] with
    every fifth 0."""
    x, ws, target, g = _problem(ERD_DIMS, P, seed)
    ws[6] = ws[6] * 30.0
    ws[7] = torch.zeros_like(ws[7])
    z = tk.siren_forward_ref(x, ws, 30.0, ERD_ACTS[:-1] + ("none",))
    # about half the rows on either side, none within rounding of the step
    zs = z.flatten().sort().values
    assert float(zs[P // 2 + 1] - zs[P // 2]) > 1e-6
    ws[7] = -0.5 * (zs[P // 2] + zs[P // 2 + 1]).reshape(1)
    sw = torch.as_tensor(np.random.default_rng(seed + 1).uniform(0, 1, size=(P, 1)),
                         dtype=torch.float32)
    sw[::5] = 0.0
    return x, ws, target, g, sw


def _assert_k1(lib, x, ws, target, n_rows, sw, absmax, acts=ERD_ACTS):
    got = tk._launch_loss_grads(lib, x, ws, target, 30.0, n_rows, 0, acts, sw, absmax)
    want = tk.siren_loss_grads_ref(x, ws, target, 30.0, n_rows, acts, sw, absmax)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    if absmax:
        torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
    for i, (a, b) in enumerate(zip(got[-1], want[-1])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6, msg=f"grad {i}")
    return got, want


@pytest.mark.parametrize("weighted,absmax", [(True, False), (False, True), (True, True)])
def test_emulated_k1_variants_match_plain(emulated_lib, weighted, absmax):
    """Sample weights (zeros among them) and max |out| over the real rows,
    with ReLU codes; the row holding the largest |out| moved past n_rows, so
    a max taken over the padded rows would show, and the real maximum in a
    row past the first block's eight, so that only the reduction over the
    blocks' partials finds it."""
    P = 300
    x, ws, target, _, sw = _erd_problem(P, seed=11)
    out = tk.siren_forward_ref(x, ws, 30.0, ERD_ACTS)
    last = int(out.abs().argmax())
    order = [i for i in range(P) if i != last] + [last]
    x, target, sw = x[order].contiguous(), target[order].contiguous(), sw[order].contiguous()
    n_rows = P - 1
    out = out[order]
    assert 0.2 < float((out > 0).float().mean()) < 0.8  # the output ReLU on and off
    assert float(out[:n_rows].abs().max()) < float(out.abs().max())
    assert int(out[:n_rows].abs().argmax()) >= 8
    _assert_k1(emulated_lib, x, ws, target, n_rows, sw if weighted else None, absmax)
    _assert_k1(emulated_lib, x, ws, target, P, sw if weighted else None, absmax)


def test_emulated_k1_relu_step_is_zero_at_zero(emulated_lib):
    """Pre-activations exactly 0: one unit of the ReLU layer with zero
    weights and bias, and then the whole ReLU layer off (bias -100) with a
    last bias of 0, so the output is ReLU(0) everywhere. The step is 0 at
    z = 0, so the zero unit's and, in the second case, every gradient is
    exactly 0; max |out| is exactly 0 there."""
    P = 137
    x, ws, target, g, sw = _erd_problem(P, seed=5)
    ws = [w.clone() for w in ws]
    ws[4][3].zero_()
    ws[5][3] = 0.0
    (_, _, grads), _ = _assert_k1(emulated_lib, x, ws, target, P, sw, True)
    assert float(grads[4][3].abs().max()) == 0.0 and float(grads[5][3]) == 0.0
    ws[5].fill_(-100.0)
    ws[7].zero_()
    (loss, absmax, grads), _ = _assert_k1(emulated_lib, x, ws, target, P - 7, sw, True)
    assert float(absmax) == 0.0 and float(loss) > 0
    assert all(float(q.abs().max()) == 0.0 for q in grads)
    dx, dws = tk._launch_fused_bwd(emulated_lib, x, ws, g, 30.0, True, True, 0, ERD_ACTS)
    assert float(dx.abs().max()) == 0.0 and all(float(q.abs().max()) == 0.0 for q in dws)


@pytest.mark.parametrize("acts", [ERD_ACTS, ("sine", "none", "relu", "none"),
                                  ("relu", "sine", "sine", "relu")])
def test_emulated_k2_k3_take_the_codes(emulated_lib, acts):
    P = 201
    x, ws, _, g, _ = _erd_problem(P, seed=2)
    torch.testing.assert_close(tk._launch_forward(emulated_lib, x, ws, 30.0, 0, acts),
                               tk.siren_forward_ref(x, ws, 30.0, acts), rtol=1e-5, atol=1e-6)
    dx, dws = tk._launch_fused_bwd(emulated_lib, x, ws, g, 30.0, True, True, 0, acts)
    dx_r, dws_r = tk.siren_fused_bwd_ref(x, ws, g, 30.0, acts=acts)
    torch.testing.assert_close(dx, dx_r, rtol=1e-4, atol=1e-5)
    for a, b in zip(dws, dws_r):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def _weighted_problem(dims, P, seed):
    """Seeded inputs at SIREN-init scale; sample weights in [0, 1] with
    every fifth 0."""
    x, ws, target, _ = _problem(dims, P, seed)
    sw = torch.as_tensor(np.random.default_rng(seed + 1).uniform(0, 1, size=(P, 1)),
                         dtype=torch.float32)
    sw[::5] = 0.0
    return x, ws, target, sw


def _assert_k1_simt(lib, x, ws, target, n_rows, sw=None, absmax=False, acts=None, omega=30.0):
    """The SIMT launch against the plain K1; returns the launch's result."""
    got = tk._launch_loss_grads(lib, x, ws, target, omega, n_rows, 0, acts, sw, absmax)
    want = tk.siren_loss_grads_ref(x, ws, target, omega, n_rows, acts, sw, absmax)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    if absmax:
        torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
    assert len(got[-1]) == len(ws)
    for i, (a, b) in enumerate(zip(got[-1], want[-1])):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6, msg=f"grad {i}")
    return got


@pytest.mark.parametrize("weighted,n_rows", [(False, 137), (True, 120), (True, 137)])
def test_emulated_k1_absmax_relu_masked(emulated_lib, weighted, n_rows):
    """max |out| and ReLU codes at widths off the streaming route's (a
    SirenERD-like trunk 2 -> 24 -> 24 -> 20 -> 1 whose output ReLU is on for
    about half the rows), with and without sample weights and masked rows;
    the row of the largest |out| is last, so a max over masked rows would
    show."""
    P = 137
    x, ws, target, sw = _weighted_problem(ERD_DIMS, P, seed=5)
    assert tk.k1_route(ERD_DIMS, ERD_ACTS, weighted, True) == "simt"
    ws[6], ws[7] = ws[6] * 30.0, torch.zeros_like(ws[7])
    z = tk.siren_forward_ref(x, ws, 30.0, ERD_ACTS[:-1] + ("none",)).flatten()
    ws[7] = -z.median().reshape(1)
    out = tk.siren_forward_ref(x, ws, 30.0, ERD_ACTS).flatten()
    last = int(out.abs().argmax())
    order = [i for i in range(P) if i != last] + [last]
    x, target, sw = x[order].contiguous(), target[order].contiguous(), sw[order].contiguous()
    assert 0.2 < float((out > 0).float().mean()) < 0.8
    _assert_k1_simt(emulated_lib, x, ws, target, n_rows, sw if weighted else None, True,
                    ERD_ACTS)


def test_emulated_k1_relu_step_is_zero_at_zero_weighted(emulated_lib):
    """Pre-activations exactly 0 with sample weights and masked rows: one
    unit of the ReLU layer with zero weights and bias, then the whole ReLU
    layer off (bias -100) and a last bias of 0, so the output is ReLU(0)
    everywhere. The step is 0 at z = 0, so that unit's and then every
    gradient are exactly 0, and so is max |out|."""
    P = 137
    x, ws, target, sw = _weighted_problem(ERD_DIMS, P, seed=5)
    ws[6] = ws[6] * 30.0
    ws[4][3].zero_()
    ws[5][3] = 0.0
    _, _, grads = _assert_k1_simt(emulated_lib, x, ws, target, P, sw, True, ERD_ACTS)
    assert float(grads[4][3].abs().max()) == 0.0 and float(grads[5][3]) == 0.0
    ws[5].fill_(-100.0)
    ws[7].zero_()
    loss, absmax, grads = _assert_k1_simt(emulated_lib, x, ws, target, P - 7, sw, True, ERD_ACTS)
    assert float(absmax) == 0.0 and float(loss) > 0
    assert all(float(g.abs().max()) == 0.0 for g in grads)


@pytest.mark.parametrize("dims,acts,P", [
    ((3, 10, 7, 1), ("sine", "sine", "none"), 45),  # widths off the multiple of 4
    ((3, 10, 7, 1), ("sine", "none", "none"), 45),
    ((5, 6, 1), ("relu", "relu"), 33),  # one hidden layer
])
def test_emulated_k1_odd_widths(emulated_lib, dims, acts, P):
    """Widths off the multiple of 4, one omega per hidden layer, sample
    weights and masked rows: the SIMT route's (:func:`k1_route`)."""
    assert tk.k1_route(dims, acts, True) == "simt"
    x, ws, target, sw = _weighted_problem(dims, P, seed=sum(dims))
    omegas = [7.0 + 4.0 * l for l in range(len(dims) - 2)]
    _assert_k1_simt(emulated_lib, x, ws, target, P - 2, sw, True, acts, omega=omegas)


def test_emulated_k1_many_row_blocks(emulated_lib):
    """4,300 rows (2 -> 8 -> 1, weighted, masked): the last layer's loss
    partials span many row blocks and the dW sums several splits."""
    x, ws, target, sw = _weighted_problem((2, 8, 1), 4300, seed=3)
    _assert_k1_simt(emulated_lib, x, ws, target, 4290, sw)


def test_emulated_k1_zero_sample_weights(emulated_lib):
    """All sample weights 0: the loss, every dW and db exactly 0."""
    x, ws, target, sw = _weighted_problem((2, 16, 16, 1), 50, seed=4)
    loss, grads = tk._launch_loss_grads(emulated_lib, x, ws, target, 30.0, 50, 0, None,
                                        torch.zeros_like(sw))
    assert float(loss) == 0.0 and all(float(g.abs().max()) == 0.0 for g in grads)
