"""The yardstick of the roofline and ``mfu`` metrics: the chip's peaks and
the operations and compulsory bytes of an MLP's passes, from its layer
widths alone.

An operation is one multiply-add of a product (two FLOPs, as the peak
counts them); sines, biases and the optimizer's elementwise work are not
counted. The bytes are each input read once and each output written once,
float32. The peak is the H100 SXM's dense bf16 tensor-core rate: the
configurations are float32, the port keeps float32 accuracy with bf16x3
products, and no route that keeps that accuracy can beat the bf16 rate, so
a share of it cannot pass 100% whatever implements the work.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12  # H100 SXM, dense bf16, NVIDIA's data sheet (700 W)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
F32 = 4


def layer_macs(dims) -> list[int]:
    """Multiply-adds per row of each layer of ``dims[0] -> ... -> dims[-1]``."""
    return [int(i) * int(o) for i, o in zip(dims[:-1], dims[1:])]


def n_params(dims) -> int:
    return sum(int(i) * int(o) + int(o) for i, o in zip(dims[:-1], dims[1:]))


def macs_per_row(kind: str, dims) -> int:
    """Multiply-adds per row and model of one pass:

    - ``forward``: every layer's product;
    - ``loss_grads``: the forward, every layer's dW and the input gradient
      of every layer but the first (what K1 returns: loss and weight
      gradients);
    - ``input_grad``: the input gradient of every layer (K2 asked for dx
      alone);
    - ``grads``: every layer's dW and the input gradient of every layer but
      the first (autograd's backward of a small network's weights)."""
    m = layer_macs(dims)
    if kind == "forward":
        return sum(m)
    if kind == "loss_grads":
        return sum(m) + sum(m) + sum(m[1:])
    if kind == "input_grad":
        return sum(m)
    if kind == "grads":
        return sum(m) + sum(m[1:])
    raise ValueError(f"unknown pass {kind!r}")


def flops(kind: str, dims, rows: int, slots: int = 1) -> float:
    return 2.0 * macs_per_row(kind, dims) * int(rows) * int(slots)


def compulsory_bytes(kind: str, dims, rows: int, slots: int = 1, weighted: bool = False) -> float:
    """Bytes a pass must move: its inputs read once, its outputs written
    once. ``forward``: x, the weights; out. ``loss_grads``: x, each slot's
    target (and sample weights), the weights; the gradients and the loss."""
    rows, slots = int(rows), int(slots)
    x = rows * int(dims[0])
    w = slots * n_params(dims)
    if kind == "forward":
        return F32 * (x + w + slots * rows * int(dims[-1]))
    if kind == "loss_grads":
        per_row = slots * rows * (2 if weighted else 1)
        return F32 * (x + per_row + w + w + slots)
    raise ValueError(f"no byte count for pass {kind!r}")


def roofline_s(kind: str, dims, rows: int, slots: int = 1, weighted: bool = False) -> float:
    """The least time the pass needs on the chip."""
    return max(flops(kind, dims, rows, slots) / PEAK_FLOPS,
               compulsory_bytes(kind, dims, rows, slots, weighted) / PEAK_BYTES)


def products_flops(products) -> float:
    """FLOPs of the model work a window completed: ``products`` lists
    ``(kind, dims, rows, slots, count)``."""
    return sum(flops(kind, dims, rows, slots) * count
               for kind, dims, rows, slots, count in products)


def span_roofline_share(run, span: str) -> float | None:
    """100 x the least time of the work launched inside the spans ``span``
    (signatures ``(kind, dims, rows, slots, weighted)``) over the device
    time of all that it launched; None when nothing was traced there."""
    trace, work = run.get("trace"), run["spans"].work.get(span)
    if trace is None or not work:
        return None
    device = trace.span_device_s(span)
    if not device:
        return None
    least = sum(roofline_s(*sig) * n for sig, n in work.items())
    return 100.0 * least / device


def mfu(run) -> float | None:
    """100 x the FLOPs of the traced window's model work over what the
    peak does in the window."""
    trace = run.get("trace")
    if trace is None or trace.busy_s() is None:  # no device activity traced
        return None
    return 100.0 * products_flops(run["window"]["products"]) / (trace.window_s() * PEAK_FLOPS)


def idle_share(run) -> float | None:
    trace = run.get("trace")
    busy = trace.busy_s() if trace is not None else None
    if busy is None:
        return None
    return 100.0 * (1.0 - busy / trace.window_s())
