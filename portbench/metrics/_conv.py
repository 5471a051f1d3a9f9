"""The yardstick of the RAMS cell's roofline and ``mfu`` metrics: the
operations and compulsory bytes of a convolution from its shapes alone, and
the list of a RAMS forward's convolutions from the configuration, so that
the same work is counted whatever implements it.

An operation is one multiply-add (two FLOPs): ``2 x B x prod(out) x
prod(kernel) x Cin x Cout``, the padded border's zeros counted as a SAME
conv computes them. The bytes are the input, the kernel and the bias read
once and the output written once, at the dtypes the configuration runs
them in. The peaks are ``_count``'s.
"""
from __future__ import annotations

import math
from typing import NamedTuple

from portbench.metrics._count import PEAK_BYTES, PEAK_FLOPS

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


class Conv(NamedTuple):
    name: str  # its layer in the forward
    batch: int
    inp: tuple  # input spatial shape (as the conv reads it, after any reflect pad)
    out: tuple  # output spatial shape
    kernel: tuple  # kernel spatial shape
    cin: int
    cout: int
    act_bytes: int  # an input or output element
    weight_bytes: int  # a kernel element as the conv reads it
    bias_bytes: int


def conv(name: str, batch: int, inp, kernel, cin: int, cout: int, padding: str,
         act_bytes: int, weight_bytes: int, bias_bytes: int) -> Conv:
    """A conv of ``inp`` (spatial) by ``kernel`` with SAME (zero, output as
    input) or VALID padding."""
    inp, kernel = tuple(int(n) for n in inp), tuple(int(k) for k in kernel)
    if padding == "SAME":
        out = inp
    elif padding == "VALID":
        out = tuple(n - k + 1 for n, k in zip(inp, kernel))
    else:
        raise ValueError(f"padding must be SAME or VALID; got {padding!r}")
    return Conv(name, int(batch), inp, out, kernel, int(cin), int(cout), act_bytes,
                weight_bytes, bias_bytes)


def flops(c: Conv) -> float:
    return 2.0 * c.batch * math.prod(c.out) * math.prod(c.kernel) * c.cin * c.cout


def compulsory_bytes(c: Conv) -> float:
    return float(c.act_bytes * c.batch * (math.prod(c.inp) * c.cin + math.prod(c.out) * c.cout)
                 + c.weight_bytes * math.prod(c.kernel) * c.cin * c.cout
                 + c.bias_bytes * c.cout)


def roofline_s(c: Conv) -> float:
    """The least time the conv needs on the chip."""
    return max(flops(c) / PEAK_FLOPS, compulsory_bytes(c) / PEAK_BYTES)


def body_conv(c: Conv) -> bool:
    """One of the 3x3x3 convs from the filters to the filters (the RFABs',
    the body conv, the temporal steps'): 34 a forward at the reference
    architecture, those the port runs on K6."""
    return c.kernel == (3, 3, 3) and c.cin == c.cout


def rams_convs(cfg: dict, batch: int, height: int, width: int) -> list[Conv]:
    """Every convolution of one RAMS forward on ``batch`` draws of
    ``(height, width, channels)``, in call order: activations in
    ``compute_dtype``, the 3x3x3 body convs' kernels rounded to it and
    their biases float32 (K6), the other convs' kernels and biases in it;
    the gates' 1x1 convs float32 on the pooled features."""
    f, t, s, r = cfg["filters"], cfg["channels"], cfg["scale"], cfg["r"]
    act = DTYPE_BYTES[cfg["compute_dtype"]]
    h, w = height + 2, width + 2  # reflect-padded
    out: list[Conv] = []

    def gate(name, channels, nd):
        one = (1,) * nd
        out.append(conv(name + ".att0", batch, one, one, channels, channels // r, "VALID", 4, 4, 4))
        out.append(conv(name + ".att1", batch, one, one, channels // r, channels, "VALID", 4, 4, 4))

    def rfab(name, inp):
        for part in ("conv0", "conv1"):
            out.append(conv(f"{name}.{part}", batch, inp, (3, 3, 3), f, f, "SAME", act, act, 4))
        gate(name, f, 3)

    out.append(conv("head", batch, (h, w, t), (3, 3, 3), 1, f, "SAME", act, act, act))
    for i in range(cfg["N"]):
        rfab(f"rfabs.{i}", (h, w, t))
    out.append(conv("body_conv", batch, (h, w, t), (3, 3, 3), f, f, "SAME", act, act, 4))
    depth = t
    for i in range(t // 3):
        rfab(f"reduce_rfabs.{i}", (h + 2, w + 2, depth))
        out.append(conv(f"reduce_convs.{i}", batch, (h + 2, w + 2, depth), (3, 3, 3), f, f,
                        "VALID", act, act, 4))
        depth -= 2
    out.append(conv("to_scale", batch, (h, w, depth), (3, 3, 3), f, s * s, "VALID", act, act, act))
    for part in ("conv0", "conv1"):
        out.append(conv(f"rtab.{part}", batch, (h, w), (3, 3), t, t, "SAME", act, act, act))
    gate("rtab", t, 2)
    out.append(conv("global_conv", batch, (h, w), (3, 3), t, s * s, "VALID", act, act, act))
    return out


def body_least_s(convs) -> float:
    """The least time of the body convs of one forward."""
    return sum(roofline_s(c) for c in convs if body_conv(c))


def forward_flops(convs) -> float:
    return sum(flops(c) for c in convs)
