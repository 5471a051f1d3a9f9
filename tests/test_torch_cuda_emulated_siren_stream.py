"""The CUDA source of K1's streaming tensor-core route
(``csrc/siren_stream.cu``, with ``csrc/gemm3.cuh``, ``csrc/slots.cuh`` and
``csrc/tensor_core.cuh``) runs on the CPU under an emulation of the CUDA
execution model (``tests/cuda_emulation``: one fiber per CUDA thread, block
barriers, warp shuffles, ``mma.sync`` and ``ldmatrix`` through per-warp
buffers, shared memory filled with NaN bits at each block's start), through
the same ctypes launch code the wrapper uses on the card, against the plain
float32 version.

Cases: a SirenERD-like trunk 2 -> 64x2 -> 64 (ReLU) -> 1 (ReLU) with max
|out| on 300 rows (three row tiles of 128, the last ragged, whose slots the
third launch sums), masked rows, sample weights with zeros, a collapsed
output (max |out| exactly 0); the plain Siren's codes with several sine
omegas; the 2-D ensemble's Siren 2 -> 64x7 -> 1 with sample weights (every
fifth 0), masked rows and a ragged last tile; bits that repeat; the
shared-memory plan against the host's formula, and the kernel's query
against :func:`k1_route`.

Tolerance: the tensor-core route's products are bf16x3 (each operand split
into two bf16 planes, ``|x - hi - lo| <= 2^-16 |x|``), float32 sums: the
loss within 1e-4 relative and max |out| within 1e-5 relative; each dW/db
within 1e-3 of its largest magnitude (``chip_smoke.py``'s K1 bar).
"""
import ctypes

import numpy as np
import pytest
import torch

from cuda_emulation.emulated import emulated_library
from mri_super_resolution_tpu_torch.ops import siren_kernel as tk

torch.set_num_threads(2)

ERD_DIMS = (2, 64, 64, 64, 1)
MASTER_DIMS = (2,) + (64,) * 7 + (1,)
ERD_ACTS = ("sine", "sine", "relu", "relu")


@pytest.fixture(scope="module")
def emulated_stream(tmp_path_factory):
    return emulated_library(tmp_path_factory, "siren_stream", tk._stream_declare)


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


def _erd_problem(P, seed):
    """The trunk with its head scaled so that the output ReLU is on for
    about half the rows; the row of the largest |out| is last, so a max over
    masked rows would show."""
    x, ws, target, sw = _problem(ERD_DIMS, P, seed)
    ws[6], ws[7] = ws[6] * 30.0, torch.zeros_like(ws[7])
    z = tk.siren_forward_ref(x, ws, 30.0, ERD_ACTS[:-1] + ("none",)).flatten()
    ws[7] = -z.median().reshape(1)
    out = tk.siren_forward_ref(x, ws, 30.0, ERD_ACTS).flatten()
    assert 0.2 < float((out > 0).float().mean()) < 0.8
    last = int(out.abs().argmax())
    order = [i for i in range(P) if i != last] + [last]
    return x[order].contiguous(), ws, target[order].contiguous(), sw[order].contiguous()


def _assert_k1(lib, x, ws, target, n_rows, sw=None, absmax=False, acts=None, omega=30.0):
    """The streaming launch against the plain K1; returns the launch's result."""
    got = tk._launch_loss_grads_slots("stream", lib, x, ws, target, omega, n_rows, 0, acts, sw,
                                      absmax)
    want = tk.siren_loss_grads_ref(x, ws, target, omega, n_rows, acts, sw, absmax)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0)
    if absmax:
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    assert len(got[-1]) == len(ws)
    for i, (a, b) in enumerate(zip(got[-1], want[-1])):
        assert a.shape == b.shape
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        assert err <= 1e-3, f"grad {i}: {err:.2e} of its largest magnitude"
    return got


@pytest.mark.parametrize("n_rows,weighted", [(300, False), (251, True), (300, True)])
def test_emulated_stream_absmax_relu(emulated_stream, n_rows, weighted):
    """K1-a's options on three row tiles (the last ragged): max |out|, the
    ReLU codes, masked rows and sample weights with zeros; a second call
    gives the same bits (the slots are summed in block order)."""
    assert tk.stream_route(ERD_DIMS)
    x, ws, target, sw = _erd_problem(300, seed=5)
    sw = sw if weighted else None
    got = _assert_k1(emulated_stream, x, ws, target, n_rows, sw, True, ERD_ACTS)
    again = tk._launch_loss_grads_slots("stream", emulated_stream, x, ws, target, 30.0, n_rows,
                                        0, ERD_ACTS, sw, True)
    assert all(torch.equal(a, b) for a, b in zip(got[:2], again[:2]))
    assert all(torch.equal(a, b) for a, b in zip(got[2], again[2]))


def test_emulated_stream_collapsed_output(emulated_stream):
    """A collapsed output (the head's ReLU off everywhere, a last bias of
    0): max |out| exactly 0, every gradient exactly 0, the loss the target's
    mean square."""
    x, ws, target, sw = _problem(ERD_DIMS, 200, seed=6)
    ws[5].fill_(-100.0)
    ws[7].zero_()
    loss, absmax, grads = _assert_k1(emulated_stream, x, ws, target, 190, sw, True, ERD_ACTS)
    assert float(absmax) == 0.0 and float(loss) > 0
    assert all(float(g.abs().max()) == 0.0 for g in grads)


@pytest.mark.parametrize("P,n_rows,weighted", [
    (100, 100, True),  # weighted rows with zeros, one ragged tile (100 of 128 rows)
    (100, 77, True),  # masked rows
    (64, 64, False),  # unweighted
])
def test_emulated_stream_master_shape(emulated_stream, P, n_rows, weighted):
    """The 2-D ensemble's widths, which K1 sends here with any of its
    options; the slots are summed in block order: a second call gives the
    same bits."""
    assert tk.k1_route(MASTER_DIMS, ("sine",) * 7 + ("none",), weighted) == "stream"
    x, ws, target, sw = _problem(MASTER_DIMS, P, seed=P + n_rows)
    sw = sw if weighted else None
    got = _assert_k1(emulated_stream, x, ws, target, n_rows, sw)
    again = tk._launch_loss_grads_slots("stream", emulated_stream, x, ws, target, 30.0, n_rows,
                                        0, None, sw)
    assert torch.equal(got[0], again[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], again[1]))


@pytest.mark.parametrize("dims,acts,omega", [
    ((3, 64, 64, 64, 1), None, [30.0, 7.0, 12.0]),  # the plain Siren's codes, an omega each
    ((2, 128, 128, 1), ("sine", "none", "none"), 30.0),  # K1-a's width, a linear layer
])
def test_emulated_stream_codes_and_widths(emulated_stream, dims, acts, omega):
    x, ws, target, sw = _problem(dims, 140, seed=sum(dims))
    _assert_k1(emulated_stream, x, ws, target, 133, sw, False, acts, omega)


def test_emulated_stream_plan_and_refusals(emulated_stream):
    """The host's shared-memory plan is the kernel's, and the kernel's
    query takes exactly the widths the route takes: hidden widths of 64 and
    128 (192 is over one block's shared memory), equal hidden widths, one
    output; the route order keeps K1's flagship on the tensor-core route and
    sends the 2-D ensemble's Siren here."""

    def query(dims):
        arr = (ctypes.c_int * len(dims))(*dims)
        ptr = ctypes.cast(arr, ctypes.c_void_p)
        return (emulated_stream.siren_stream_smem_bytes(ptr, len(dims) - 1),
                emulated_stream.siren_stream_work_floats(1000, ptr, len(dims) - 1))

    for dims in (ERD_DIMS, (2, 128, 128, 128, 128, 128, 1), (3, 64, 64, 1), (2, 192, 192, 1),
                 (2, 256, 256, 1), (2, 64, 128, 1), (2, 64, 1), (2, 64, 64, 2), (2, 96, 96, 1),
                 (2,) + (64,) * 15 + (1,), (2,) + (64,) * 16 + (1,), (300, 128, 128, 1)):
        smem, work = query(dims)
        assert (smem >= 0) is (work >= 0) is tk.stream_route(dims), dims
        if smem >= 0:
            assert smem == tk.stream_smem_bytes(dims) <= tk.SMEM_MAX
    assert tk.stream_smem_bytes((2, 128, 128, 1)) == 175_616
    assert tk.stream_smem_bytes((2, 192, 192, 1)) > tk.SMEM_MAX
    assert tk.k1_route((2, 128, 128, 128, 128, 128, 1), ERD_ACTS[:2] * 2 + ("relu", "relu"),
                       absmax=True) == "stream"
    assert tk.k1_route((256, 512, 512, 512, 512, 1), ("sine",) * 4 + ("none",)) == "wg"
    assert tk.k1_route((2,) + (64,) * 7 + (1,), ("sine",) * 7 + ("none",),
                       weighted=True) == "stream"
    x, ws, target, _ = _problem((2, 96, 96, 1), 4, seed=0)
    with pytest.raises(ValueError):
        tk._launch_loss_grads_slots("stream", emulated_stream, x, ws, target, 30.0, 4, 0)


def test_emulated_stream_query_is_k1_route(emulated_stream):
    """For a K1 call off the tensor-core route (here with sample weights)
    the streaming kernel's workspace query takes exactly the widths that
    :func:`k1_route` sends to it, the 2-D ensemble's among them; the rest
    go to the SIMT route, which takes any widths: one hidden layer, widths
    off a multiple of 64 or over one block's plan, too many layers, more
    than one output. Unweighted, the flagship takes the tensor-core route."""

    def work(dims):
        arr = (ctypes.c_int * len(dims))(*dims)
        return emulated_stream.siren_stream_work_floats(100, ctypes.cast(arr, ctypes.c_void_p),
                                                        len(dims) - 1)

    routes = {}
    for dims in (MASTER_DIMS, (2, 24, 24, 20, 1), (3, 10, 7, 1), (2, 8, 1), (64, 96, 130, 1),
                 (256, 512, 512, 512, 512, 1), (2, 1), (2, 8, 2), (2,) + (4,) * 17 + (1,),
                 *((2,) + (h,) * 7 + (1,) for h in range(70, 82)),
                 *((h, h, 1) for h in range(176, 186))):
        acts = ("sine",) * (len(dims) - 2) + ("none",)
        route = routes[dims] = tk.k1_route(dims, acts, weighted=True)
        assert (work(dims) >= 0) is (route == "stream") and route in ("stream", "simt"), dims
    assert routes[MASTER_DIMS] == "stream" and routes[(3, 10, 7, 1)] == "simt"
    assert tk.k1_route((256, 512, 512, 512, 512, 1), ("sine",) * 4 + ("none",)) == "wg"
