"""The RFAB gate's routing on the CPU (``models/rams.py``, ``ops/rams_gate.py``):
every CPU run, every run with grad on and every export trace keeps the eager
chain, bit for bit as before G1 existed, and the counts say so; G1's plain
version and its weight plumbing agree with the eager chain; the wrapper
refuses what its kernels do not take, CPU tensors included. G1 itself runs
on the card (``tests/test_torch_cuda.py``) and under the CPU emulation
(``tests/test_torch_cuda_emulated_rams_gate.py``).
"""
import pytest
import torch

from mri_super_resolution_tpu_torch.models import rams as trams
from mri_super_resolution_tpu_torch.ops import rams_gate as rg

torch.set_num_threads(2)


def _rfab_forward_before_g1(blk, x):
    """``RFAB.forward`` as it was before the fused route: the reference the
    eager route must equal bit for bit."""
    res = x
    x = blk.conv1(torch.relu(blk.conv0(x)))
    att = x.float().mean(dim=(1, 2, 3), keepdim=True)
    att = torch.sigmoid(blk.att1(torch.relu(blk.att0(att)))).to(x.dtype)
    return x * att + res


def _rfab(filters=8, r=4, seed=0):
    gen = torch.Generator().manual_seed(seed)
    blk = trams.RFAB(filters, r=r)
    for m in blk.modules():
        if isinstance(m, trams.WNConv):
            m.reset_parameters(gen)
            with torch.no_grad():  # a gate that is not all 0.5
                m.bias.uniform_(-0.5, 0.5, generator=gen)
    return blk


@pytest.mark.parametrize("grad", [True, False])
def test_rfab_on_the_cpu_runs_the_eager_gate(grad):
    """With grad on or off, an RFAB on CPU tensors takes the eager gate (the
    fused count stays 0) and gives the old forward's bits."""
    blk = _rfab()
    x = torch.randn(2, 5, 6, 4, 8, generator=torch.Generator().manual_seed(1))
    rg.reset_launches()
    with torch.set_grad_enabled(grad):
        got = blk(x)
        want = _rfab_forward_before_g1(blk, x)
    assert rg.LAUNCHES == {"rfab_gate": 0, "rfab_gate_eager": 1}
    assert torch.equal(got, want)
    assert got.requires_grad == grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_rams_forward_on_the_cpu_is_unchanged(monkeypatch, dtype):
    """A whole small RAMS forward on the CPU (N + T // 3 RFABs) equals the
    forward with the old RFAB, bit for bit, with every gate eager."""
    gen = torch.Generator().manual_seed(2)
    model = trams.RAMS(filters=8, N=2, r=4, compute_dtype=dtype, generator=gen)
    x = torch.rand((2, 10, 12, 9), generator=gen) * 3000 + 6000
    rg.reset_launches()
    with torch.inference_mode():
        got = model(x)
    assert rg.LAUNCHES == {"rfab_gate": 0, "rfab_gate_eager": 2 + 3}
    monkeypatch.setattr(trams.RFAB, "forward", _rfab_forward_before_g1)
    with torch.inference_mode():
        want = model(x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_gate_plain_version_agrees_with_the_eager_chain(dtype):
    """G1's plain version on ``RFAB.gate_weights`` (the weight-normed 1x1x1
    kernels reshaped (C, R) and (R, C)): float32 within 1e-6 of the eager
    chain; bf16 within a bf16 rounding of the product (the gate itself may
    round the other way)."""
    blk = _rfab(filters=32, r=8, seed=3)
    gen = torch.Generator().manual_seed(4)
    x = (torch.randn(3, 6, 5, 4, 32, generator=gen) + 0.5).to(dtype)
    res = torch.randn(3, 6, 5, 4, 32, generator=gen).to(dtype)
    with torch.no_grad():
        fused = rg.rfab_gate_ref(x, res, *blk.gate_weights())
        eager = blk.gate_eager(x, res)
    assert fused.dtype == dtype and fused.shape == x.shape
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(fused.float(), eager.float(), rtol=tol, atol=tol)


def test_fused_applies_only_to_what_the_kernels_take():
    """No CPU tensor takes the fused route; ``refusal`` names the reason for
    inputs the kernels do not take, CPU tensors last, and the wrapper raises
    it."""
    x = torch.zeros(2, 4, 4, 3, 32)
    assert "runs on the card" in rg.refusal(x, x)
    with torch.no_grad():
        assert not rg.fused_applies(x)
    bad = {
        "bfloat16 or float32": (x.half(), x.half()),
        "shape": (x, x[:1]),
        "contiguous": (x.transpose(1, 2), x.transpose(1, 2)),
        "1 to 256": (torch.zeros(1, 4, 264), torch.zeros(1, 4, 264)),
        "share bfloat16": (x, x.bfloat16()),
        "runs on the card": (torch.zeros(2, 4, 12), torch.zeros(2, 4, 12)),
    }
    w0, b0, w1, b1 = torch.zeros(32, 4), torch.zeros(4), torch.zeros(4, 32), torch.zeros(32)
    for words, (a, b) in bad.items():
        assert words in rg.refusal(a, b)
        with pytest.raises(ValueError, match=words):
            rg.rfab_gate(a, b, w0, b0, w1, b1)
    with pytest.raises(ValueError, match="w1 must be contiguous float32"):
        rg._weights(32, w0, b0, w1.t(), b1, x.device)
    with pytest.raises(ValueError, match="b0 must be contiguous float32"):
        rg._weights(32, w0, b0.double(), w1, b1, x.device)


def test_a_traced_gate_is_refused():
    """``torch.export`` traces with grad off under ``no_grad``, on tensors
    without storage that G1's ctypes calls cannot take: a CUDA tensor made
    inside the trace is not routed to G1, so an exported RAMS keeps the eager
    gate (the card's own export: ``tests/test_torch_cuda.py``)."""
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            y = torch.empty(x.shape, device="cuda")
            seen.append((y.is_cuda, torch.is_grad_enabled(), rg.fused_applies(y)))
            return x * 2

    with torch.no_grad():
        torch.export.export(Probe(), (torch.zeros(2, 4, 32),))
    assert seen and all(s == (True, False, False) for s in seen)


def test_work_floats_counts_the_slots_and_the_stats():
    """The workspace: ceil(S / slot) slots an item; 38 slots an item at the
    serving shape."""
    assert rg.work_floats(25, 130 * 130 * 9, 32) == 25 * 38 * 32
    assert rg.work_floats(2, 4096, 8) == 2 * 1 * 8
    assert rg.work_floats(2, 4097, 8, 100) == 2 * 41 * 8
