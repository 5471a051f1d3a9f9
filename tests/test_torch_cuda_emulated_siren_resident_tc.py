"""The CUDA source of the batched K1-w (``csrc/siren_resident_tc.cu``, with
``csrc/common.cuh`` and ``csrc/tensor_core.cuh``) runs on the CPU under an
emulation of the CUDA execution model (``tests/cuda_emulation``: one fiber
per CUDA thread; ``mma.sync``, ``ldmatrix``, the bulk copy and its
mbarrier as the header computes them; a cooperative launch runs every block
at once, so that the kernel's grid barrier, an integer arrival counter,
really waits), through the same ctypes launch code the wrapper uses on the
card, against the plain float32 batched version.

Cases: the 2-D ensemble's Siren 2 -> 64x7 -> 1 at D = 1 and 3 with sample
weights (every fifth 0) and a padded slot (all weights 0: loss and grads
exactly 0); a ragged last tile and masked rows (``n_rows`` < P); more row
tiles than blocks (a smaller SM count: a block walks several tiles, its dW
kept in registers between them); more slots than SMs (one launch a group);
the other depths and input widths the kernel takes; weights as a
``StackedAdam`` holds them (a parameter buffer's rows apart, so the bulk
copies start off 16-byte alignment); two calls for the same bits, the grid
barrier's counter left at 0; each slot against the unbatched streaming
kernel; the refusals, and the route of each class of call.

Tolerance: each dW/db within 1e-4 of its largest magnitude and the loss
within 1e-5 relative. The products are bf16x3 (hi hi + hi lo + lo hi, each
split within 2^-16 of its value) summed in float32 in another order than
the plain version, through seven sine layers at omega = 30; measured at
most 3.6e-5 (grads) and 5.7e-7 (loss) over these cases.
"""
import ctypes

import numpy as np
import pytest
import torch

from cuda_emulation.emulated import emulated_library
from mri_super_resolution_tpu_torch.fit.optim import StackedAdam
from mri_super_resolution_tpu_torch.ops import siren_kernel as tk

torch.set_num_threads(2)

MASTER_DIMS = (2,) + (64,) * 7 + (1,)
RTC_GRAD_TOL = 1e-4  # max |kernel - plain| / max |plain|, each dW and db
RTC_LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def emulated_rtc(tmp_path_factory):
    return emulated_library(tmp_path_factory, "siren_resident_tc", tk._rtc_declare)


@pytest.fixture
def sms(monkeypatch):
    """The SM count the wrapper plans with (an H100's 132 unless set)."""

    def use(n: int) -> None:
        monkeypatch.setattr(tk, "_sm_count", lambda device: n)

    return use


def _stacked(dims, D, P, seed):
    """D seeded problems at SIREN-init scale on one x; sample weights in
    [0, 1] with every fifth 0; the weights as a StackedAdam holds them."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    x = t(rng.uniform(-1, 1, size=(P, dims[0])))
    ws = []
    for l in range(len(dims) - 1):
        b = 1.0 / dims[l] if l == 0 else np.sqrt(6.0 / dims[l]) / 30
        ws.append(t(rng.uniform(-b, b, size=(D, dims[l + 1], dims[l]))))
        ws.append(t(rng.uniform(-1, 1, size=(D, dims[l + 1])) / np.sqrt(dims[l])))
    target = t(rng.uniform(0, 1, size=(D, P, 1)))
    sw = t(rng.uniform(0, 1, size=(D, P, 1)))
    sw[:, ::5] = 0.0
    return x, StackedAdam(ws, 1e-4).params, target, sw


def _launch(lib, x, ws, target, n_rows, sw):
    return tk._launch_loss_grads_resident_tc(lib, x, ws, target, 30.0, n_rows, 0, sw)


def _assert_matches_plain(got, x, ws, target, n_rows, sw):
    want = tk.siren_loss_grads_batched_ref(x, ws, target, 30.0, n_rows, None, sw)
    torch.testing.assert_close(got[0], want[0], rtol=RTC_LOSS_RTOL, atol=0)
    assert len(got[1]) == len(ws)
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        assert a.shape == b.shape == ws[i].shape
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= RTC_GRAD_TOL, (i, err)


def _assert_same_bits(a, b):
    assert torch.equal(a[0], b[0]) and all(torch.equal(u, v) for u, v in zip(a[1], b[1]))


def _sync_counts() -> list[list[int]]:
    return [p.sync.tolist() for p in tk._PLANS.values() if p.entry == "siren_loss_grads_rtc"]


@pytest.mark.parametrize("D,P,n_rows,padded,weighted", [
    (1, 100, 100, None, True),  # one slot, a ragged last tile (100 = 3 x 32 + 4)
    (3, 100, 93, 1, True),  # three slots, masked rows, slot 1 padded
    (3, 96, 96, None, False),  # unweighted, whole tiles
])
def test_emulated_rtc_master_shape(emulated_rtc, D, P, n_rows, padded, weighted):
    """The 2-D ensemble's widths: the plain batched version, two calls for
    the same bits, and the padded slot exactly 0 while the others stay
    right; the grid barrier's counter is 0 after each call."""
    x, ws, target, sw = _stacked(MASTER_DIMS, D, P, seed=P + D)
    if padded is not None:
        sw[padded] = 0.0
    sw = sw if weighted else None
    got = _launch(emulated_rtc, x, ws, target, n_rows, sw)
    _assert_matches_plain(got, x, ws, target, n_rows, sw)
    if padded is not None:
        assert float(got[0][padded]) == 0.0
        assert all(float(g[padded].abs().max()) == 0.0 for g in got[1])
    _assert_same_bits(got, _launch(emulated_rtc, x, ws, target, n_rows, sw))
    assert all(c[0] == 0 for c in _sync_counts())


@pytest.mark.parametrize("D,P,n_rows,n_sms", [
    (3, 150, 140, 6),  # 5 tiles over 2 blocks a slot: a block walks 3 tiles
    (5, 70, 70, 4),  # 5 slots on 4 SMs: a launch of 4 slots, then one of 1
])
def test_emulated_rtc_more_tiles_than_blocks(emulated_rtc, sms, D, P, n_rows, n_sms):
    """Fewer SMs than the slots' tiles: each block keeps its dW over its
    tiles, the slots' blocks meet at the grid barrier and sum in block
    order; more slots than SMs launch a group at a time."""
    sms(n_sms)
    x, ws, target, sw = _stacked(MASTER_DIMS, D, P, seed=7 * D + P)
    got = _launch(emulated_rtc, x, ws, target, n_rows, sw)
    _assert_matches_plain(got, x, ws, target, n_rows, sw)
    _assert_same_bits(got, _launch(emulated_rtc, x, ws, target, n_rows, sw))


@pytest.mark.parametrize("dims", [
    (3, 64, 64, 1),  # two hidden layers (one hidden-to-hidden product), d0 = 3
    (1, 64, 64, 64, 1),
    (4,) + (64,) * 5 + (1,),
])
def test_emulated_rtc_other_depths(emulated_rtc, sms, dims):
    """The depths (2 to 7 hidden layers) and input widths (1 to 4) the
    kernel takes, on 3 SMs (two blocks a slot)."""
    sms(3)
    x, ws, target, sw = _stacked(dims, 2, 77, seed=sum(dims))
    got = _launch(emulated_rtc, x, ws, target, 70, sw)
    _assert_matches_plain(got, x, ws, target, 70, sw)


def test_emulated_rtc_against_unbatched_resident(emulated_rtc, tmp_path_factory):
    """Each slot against the unbatched K1 that the route takes at these
    widths, the streaming kernel (``csrc/siren_stream.cu``, bf16x3 products
    on 128-row tiles), on its own inputs: the two part by their tiles and
    orders of sums, within the tolerances."""
    stream = emulated_library(tmp_path_factory, "siren_stream", tk._stream_declare)
    x, ws, target, sw = _stacked(MASTER_DIMS, 3, 70, seed=12)
    got = _launch(emulated_rtc, x, ws, target, 66, sw)
    assert tk.k1_route(MASTER_DIMS, ("sine",) * 7 + ("none",), True) == "stream"
    for s in range(3):
        loss, grads = tk._launch_loss_grads_slots("stream", stream, x,
                                                  [w[s].contiguous() for w in ws],
                                                  target[s].contiguous(), 30.0, 66, 0, None,
                                                  sw[s].contiguous())
        torch.testing.assert_close(got[0][s], loss, rtol=RTC_LOSS_RTOL, atol=0)
        for a, b in zip(got[1], grads):
            assert float((a[s] - b).abs().max()) <= RTC_GRAD_TOL * float(b.abs().max())


def test_emulated_rtc_plan_and_refusals(emulated_rtc):
    """The wrapper's shared-memory plan is the kernel's and fits one block;
    the kernel takes exactly the widths :func:`resident_tc_route` takes and
    refuses the others (work -1, a launch raises)."""
    def query(dims):
        arr = (ctypes.c_int * len(dims))(*dims)
        p = ctypes.cast(arr, ctypes.c_void_p)
        return (emulated_rtc.siren_rtc_smem_bytes(p, len(dims) - 1),
                emulated_rtc.siren_rtc_work_floats(100, p, len(dims) - 1, 3, 132))

    plain = lambda n: ("sine",) * n + ("none",)
    for dims in (MASTER_DIMS, (2, 64, 64, 1), (4,) + (64,) * 7 + (1,), (2,) + (64,) * 8 + (1,),
                 (2, 64, 1), (5, 64, 64, 1), (2, 32, 32, 1), (2, 64, 48, 1), (2, 128, 128, 1),
                 (2, 64, 64, 2)):
        smem, work = query(dims)
        route = tk.resident_tc_route(dims, plain(len(dims) - 2), 30.0)
        assert (work >= 0) is (smem >= 0) is route, dims
        if route:
            assert smem == tk.resident_tc_smem_bytes(dims) <= tk.SMEM_MAX
    assert tk.resident_tc_smem_bytes(MASTER_DIMS) == 216_608
    # 4 tiles of 32 for 44 blocks a slot: 4 blocks a slot, a row of 25,218 floats each
    assert query(MASTER_DIMS)[1] == 3 * 4 * (25_217 + 1)
    x, ws, target, sw = _stacked((2, 32, 32, 1), 2, 40, seed=0)
    with pytest.raises(ValueError):
        _launch(emulated_rtc, x, ws, target, 40, sw)


def test_batched_routes_by_class():
    """The batched K1's route from the shapes alone: the 2-D ensemble's
    class on this kernel with or without sample weights; at the same widths
    ReLU codes or per-layer omegas run the slots in turn through the
    unbatched streaming kernel; the tensor-core class on its own kernel; the
    soft-ERD widths (streaming route) in turn."""
    plain = ("sine",) * 7 + ("none",)
    assert tk.batched_route(MASTER_DIMS, plain, 30.0, weighted=True) == "resident_tc"
    assert tk.batched_route(MASTER_DIMS, plain, 30.0) == "resident_tc"
    assert tk.batched_route(MASTER_DIMS, plain, [30.0] * 7) == "resident_tc"
    relu = ("sine",) * 5 + ("relu", "relu", "none")
    assert tk.batched_route(MASTER_DIMS, relu, 30.0, weighted=True) == "slots"
    assert tk.k1_route(MASTER_DIMS, relu, True) == "stream"
    assert tk.batched_route(MASTER_DIMS, plain, [30.0] * 6 + [20.0]) == "slots"
    assert tk.batched_route((256, 512, 512, 1), ("sine", "sine", "none"), 30.0) == "wg"
    erd = (2,) + (128,) * 5 + (1,)
    assert tk.batched_route(erd, ("sine", "sine", "relu", "relu", "relu", "relu"), 30.0) \
        == "slots"
