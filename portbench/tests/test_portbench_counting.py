"""The yardstick's operation and byte counts against hand counts."""
import pytest

from portbench.metrics import _count

SR3D = [256, 512, 512, 512, 512, 1]
ENS2D = [2] + [64] * 7 + [1]


def test_k1_forward_macs_per_row():
    # 256 x 512 + 3 x 512 x 512 + 512 x 1
    assert _count.macs_per_row("forward", SR3D) == 918_016


def test_k1_loss_grads_at_70000_rows():
    fwd = 918_016
    dx = 3 * 512 * 512 + 512  # every layer's input gradient but the first's
    assert _count.macs_per_row("loss_grads", SR3D) == 2 * fwd + dx
    assert _count.flops("loss_grads", SR3D, 70_000) == 2.0 * 70_000 * (2 * fwd + dx)
    # 3.67e11 FLOP a step: 0.371 ms at 989 TFLOP/s, bound by operations
    assert _count.roofline_s("loss_grads", SR3D, 70_000) == pytest.approx(3.6736e11 / 989e12,
                                                                          rel=1e-3)


def test_passes_and_slots():
    assert _count.macs_per_row("input_grad", SR3D) == 918_016
    assert _count.macs_per_row("grads", [257, 128, 4]) == 257 * 128 + 128 * 4 + 128 * 4
    per_row = 2 * 64 + 6 * 64 * 64 + 64
    assert _count.macs_per_row("forward", ENS2D) == per_row
    assert _count.flops("forward", ENS2D, 3_600, slots=3) == 2.0 * per_row * 3_600 * 3
    with pytest.raises(ValueError):
        _count.macs_per_row("sideways", SR3D)


def test_compulsory_bytes():
    n = _count.n_params(SR3D)
    assert n == 918_016 + 512 * 4 + 1
    rows = 70_000
    assert _count.compulsory_bytes("forward", SR3D, rows) == 4 * (rows * 256 + n + rows)
    assert _count.compulsory_bytes("loss_grads", SR3D, rows) == 4 * (rows * 256 + rows + 2 * n + 1)
    weighted = _count.compulsory_bytes("loss_grads", ENS2D, 3_600, slots=3, weighted=True)
    assert weighted == 4 * (3_600 * 2 + 2 * 3 * 3_600 + 2 * 3 * _count.n_params(ENS2D) + 3)


def test_roofline_takes_the_larger_bound():
    # a tiny product is bound by its bytes
    assert _count.roofline_s("forward", [1, 1], 10**6) == pytest.approx(
        _count.compulsory_bytes("forward", [1, 1], 10**6) / _count.PEAK_BYTES)


def test_products_flops_sums_counts():
    products = [("loss_grads", SR3D, 70_000, 1, 3), ("forward", ENS2D, 100, 3, 2)]
    want = 3 * _count.flops("loss_grads", SR3D, 70_000) + 2 * _count.flops("forward", ENS2D, 100, 3)
    assert _count.products_flops(products) == want
