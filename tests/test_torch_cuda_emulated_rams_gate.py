"""The CUDA source of G1, the RFAB gate (``csrc/rams_gate.cu``), runs on the
CPU under an emulation of the CUDA execution model (``tests/cuda_emulation``),
through the same ctypes launch code the wrapper uses on the card.

The sum and gate passes against a float64 reference (the mean from the
slots' sums within 1e-6 relative; att within 1e-6 relative of it before
one rounding to x's type), the apply pass bit for bit against torch's ``x *
att + res``, in bfloat16 and float32, C 8 and 32 on 16-byte vectors, C 4
and 12 and unaligned tensors on single elements, B > 1, S not a multiple of
a slot's pixels nor of a block's pixels a step, slots fewer than a block's
pixels a step, and more blocks than an H100 holds in one wave. Shared
memory starts as NaN bits in each emulated block and the workspace and
outputs as NaN bits, so a slot, a row or a channel that a kernel reads
without writing shows.
"""
import numpy as np
import pytest
import torch

from cuda_emulation.emulated import emulated_library
from mri_super_resolution_tpu_torch.ops import rams_gate as rg

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def emulated_gate(tmp_path_factory):
    return emulated_library(tmp_path_factory, "rams_gate", rg._declare)


def _nan(n: int, dtype, offset: int = 0) -> torch.Tensor:
    """n NaNs of ``dtype``, starting ``offset`` elements into their buffer
    (an offset of 1 leaves them off 16-byte alignment)."""
    return torch.full((n + offset,), float("nan"), dtype=dtype)[offset:]


def _placed(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of ``t`` starting ``offset`` elements into its buffer."""
    return _nan(t.numel(), t.dtype, offset).reshape(t.shape).copy_(t)


def _problem(B, S, C, dtype, seed, offset=0):
    """x and res about N(0.5, 1) in ``dtype`` (the means well away from 0)
    placed ``offset`` elements into their buffers, the gate's float32
    weights and biases (hidden width C / 8, RAMS's r)."""
    rng = np.random.default_rng(seed)
    R = max(C // 8, 1)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    x = _placed(t(rng.normal(0.5, 1.0, size=(B, S, C))).to(dtype), offset)
    res = _placed(t(rng.normal(0.5, 1.0, size=(B, S, C))).to(dtype), offset)
    w0, b0 = t(rng.normal(0, 0.3, size=(C, R))), t(rng.normal(0, 0.1, size=(R,)))
    w1, b1 = t(rng.normal(0, 0.3, size=(R, C))), t(rng.normal(0, 0.1, size=(C,)))
    return x, res, (w0, b0, w1, b1)


def _att(lib, x, weights, slot_pixels):
    """The sum and gate passes: (att, the slots' sums (B, slots, C)) from a
    workspace and att that start as NaN bits."""
    B, S, C = x.shape
    work = _nan(rg.work_floats(B, S, C, slot_pixels), torch.float32)
    att = _nan(B * C, x.dtype).reshape(B, C)
    rg._launch_att(lib, x, *weights, work, att, slot_pixels, 0)
    return att, work.reshape(B, -1, C)


def _float64_gate(x, w0, b0, w1, b1):
    m = x.double().mean(dim=1)
    h = torch.relu(m @ w0.double() + b0.double())
    return m, torch.sigmoid(h @ w1.double() + b1.double())


CASES = [
    # (B, S, C, pixels a slot, offset in elements)
    (1, 1000, 32, rg.SLOT_PIXELS, 0),  # one slot, S under it, a ragged step (P = 64)
    (2, 5000, 32, 300, 0),  # 17 slots, S not a multiple of 300, 300 not of P
    (3, 2900, 8, 7, 0),  # C 8 (P = 256, R = 1): 415 slots an item, 1245 blocks
    (2, 613, 16, 50, 0),  # C 16 (two lanes a pixel), 13 slots
    (2, 700, 12, 90, 0),  # C 12: single elements, 21 pixels a step (252 threads)
    (3, 257, 4, 64, 0),  # C 4: single elements, 64 pixels a step, 5 slots
    (2, 900, 32, 128, 1),  # C 32 off 16-byte alignment: single elements
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,C,slot_pixels,offset", CASES)
def test_emulated_gate_matches_float64(emulated_gate, B, S, C, slot_pixels, offset, dtype):
    """Every slot written; the mean from the slots' sums within 1e-6
    relative of a float64 reference on the same stored inputs; att within
    1e-6 relative of the float64 gate before one rounding to x's type (half
    an ulp of it)."""
    x, _, weights = _problem(B, S, C, dtype, seed=S + C, offset=offset)
    att, sums = _att(emulated_gate, x, weights, slot_pixels)
    assert sums.shape[1] == -(-S // slot_pixels) and bool(torch.isfinite(sums).all())
    m64, g64 = _float64_gate(x, *weights)
    mean = sums.double().sum(dim=1) / S
    assert float(((mean - m64).abs() / m64.abs()).max()) <= 1e-6
    bits = 8 if dtype == torch.bfloat16 else 24
    half_ulp = 2.0 ** (torch.floor(torch.log2(g64.abs())) - bits)
    assert bool(((att.double() - g64).abs() <= half_ulp + 1e-6 * g64.abs()).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,C,offset", [(2, 997, 32, 0), (3, 40, 8, 0), (2, 301, 12, 0),
                                          (2, 333, 32, 1)])
def test_emulated_apply_is_bit_equal_to_torch(emulated_gate, B, S, C, offset, dtype):
    """Given att, the apply pass gives torch's ``x * att + res`` bit for bit:
    the product and the sum each rounded as PyTorch's eager ops round them
    (bf16: rounded to bf16 after each; float32: no fused multiply-add), on
    16-byte vectors and on single elements (C 12, tensors off alignment)."""
    x, res, _ = _problem(B, S, C, dtype, seed=B * S, offset=offset)
    rng = np.random.default_rng(C)
    att = torch.as_tensor(rng.uniform(0.0, 1.0, size=(B, C)).astype(np.float32)).to(dtype)
    out = _nan(B * S * C, dtype, offset).reshape(B, S, C)
    rg._launch_apply(emulated_gate, x, att, res, out, 0)
    assert torch.equal(out, x * att[:, None, :] + res)


def test_emulated_gate_repeats_bit_for_bit(emulated_gate):
    """Two runs of the three passes give the same bits (no float atomics:
    the slots and every order of sums are fixed by the shape)."""
    for dtype in (torch.bfloat16, torch.float32):
        x, res, weights = _problem(2, 3001, 32, dtype, seed=5)
        runs = []
        for _ in range(2):
            att, sums = _att(emulated_gate, x, weights, 128)
            out = _nan(x.numel(), dtype).reshape(x.shape)
            rg._launch_apply(emulated_gate, x, att, res, out, 0)
            runs.append((att, sums, out))
        for a, b in zip(*runs):
            assert torch.equal(a, b)


def test_emulated_entries_refuse_what_they_do_not_take(emulated_gate):
    """-1, and nothing launched, for C of 0 or over 256, a hidden width of 0
    or over C, no pixels, a slot of no pixels, or no items."""
    lib = emulated_gate
    x = torch.zeros(1, 4, 264)
    w = torch.zeros(264 * 264)
    work = torch.zeros(4 * 264)
    p = lambda t: t.data_ptr()
    for C, R, S, span in ((0, 1, 4, 1), (264, 1, 4, 1), (32, 0, 4, 1), (32, 33, 4, 1),
                          (32, 4, 0, 1), (32, 4, 4, 0)):
        assert lib.rams_gate_att_f32(p(x), 1, S, C, p(w), p(w), R, p(w), p(w), span, p(work),
                                     p(work), 0) == -1
    assert lib.rams_gate_apply_f32(p(x), p(x), p(x), 1, 4, 264, p(x), 0) == -1
    assert lib.rams_gate_apply_f32(p(x), p(x), p(x), 0, 4, 8, p(x), 0) == -1
