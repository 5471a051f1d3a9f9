"""The port's CUDA kernels on the card. Every test here needs an NVIDIA GPU
and skips without one; the file imports neither JAX nor the JAX package, so
it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu_torch import set_float32_precision
from mri_super_resolution_tpu_torch.models import RAMS, Wire
from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck
from mri_super_resolution_tpu_torch.ops import siren_kernel as tk
from mri_super_resolution_tpu_torch.ops import wire_kernel as wk


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    set_float32_precision()  # no TF32 in matmuls or cuDNN convs
    return torch.device("cuda")


def _problem(card, P=1000, dims=(64, 96, 96, 1), seed=1):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=card)
    x = t(rng.uniform(-1, 1, size=(P, dims[0])))
    ws = []
    for l in range(len(dims) - 1):
        b = 1.0 / dims[l] if l == 0 else np.sqrt(6.0 / dims[l]) / 30
        ws.append(t(rng.uniform(-b, b, size=(dims[l + 1], dims[l]))))
        ws.append(t(rng.uniform(-0.1, 0.1, size=(dims[l + 1],))))
    return x, ws, t(rng.uniform(0, 1, size=(P, 1))), t(rng.normal(size=(P, 1)) / P)


@pytest.mark.cuda
def test_kernels_launch_and_match_plain(card):
    """On a CUDA device each wrapper launches its kernel once (the counts
    move) and agrees with its plain version, ragged rows and widths too."""
    x, ws, target, g = _problem(card, P=1000, dims=(64, 96, 130, 1))
    tk.reset_launches()
    torch.testing.assert_close(tk.siren_forward(x, ws), tk.siren_forward_ref(x, ws),
                               rtol=1e-4, atol=1e-6)
    loss, grads = tk.siren_loss_grads(x, ws, target, n_rows=900)
    loss_r, grads_r = tk.siren_loss_grads_ref(x, ws, target, n_rows=900)
    torch.testing.assert_close(loss, loss_r, rtol=1e-4, atol=0)
    for a, b in zip(grads, grads_r):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-6)
    dx, dws = tk.siren_fused_bwd(x, ws, g)
    dx_r, dws_r = tk.siren_fused_bwd_ref(x, ws, g)
    torch.testing.assert_close(dx, dx_r, rtol=1e-3, atol=1e-8)
    for a, b in zip(dws, dws_r):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-8)
    assert tk.LAUNCHES == {"siren_forward": 1, "siren_loss_grads": 1,
                           "siren_fused_bwd": 1}


@pytest.mark.cuda
def test_autograd_function_on_card(card):
    x, ws, target, _ = _problem(card, P=777)
    xk = x.clone().requires_grad_()
    wk = [w.clone().requires_grad_() for w in ws]
    loss = torch.mean((tk.siren_fused(xk, wk) - target) ** 2)
    gk = torch.autograd.grad(loss, [xk, *wk])
    xr = x.clone().requires_grad_()
    wr = [w.clone().requires_grad_() for w in ws]
    loss_r = torch.mean((tk.siren_forward_ref(xr, wr) - target) ** 2)
    gr = torch.autograd.grad(loss_r, [xr, *wr])
    for a, b in zip(gk, gr):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-7)


@pytest.mark.cuda
def test_wrappers_refuse_mixed_devices(card):
    x, ws, target, _ = _problem(card, P=10)
    with pytest.raises(ValueError):
        tk.siren_loss_grads(x, ws, target.cpu())


def _wire(card, P, H, nh, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = Wire(4, H, nh, omega_0=10.0, sigma_0=5.0, generator=gen).to(card)
    model.requires_grad_(False)
    x = (torch.rand(P, 4, generator=gen) * 2 - 1).to(card)
    return model, x, torch.rand(P, 1, generator=gen).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("P,H,nh,n_rows", [(1000, 96, 2, 900), (777, 130, 1, 777),
                                           (33, 16, 0, 20)])
def test_wire_kernels_launch_and_match_plain(card, P, H, nh, n_rows):
    """K5 and K4 launch once each (the counts move) and agree with their
    plain versions: ragged rows, widths off the 128 tile, 0-2 hidden
    layers, masked rows."""
    model, x, target = _wire(card, P, H, nh)
    ws, _, oms = wk.split_params(model.params(), nh)
    wk.reset_launches()
    out = wk.wire_forward(x, ws, oms)
    ref = wk.wire_forward_ref(x, ws, oms)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-6 * float(ref.abs().max()))
    loss, grads = wk.wire_loss_grads(x, ws, oms, target, n_rows=n_rows)
    loss_r, grads_r = wk.wire_loss_grads_ref(x, ws, oms, target, n_rows=n_rows)
    torch.testing.assert_close(loss, loss_r, rtol=1e-4, atol=0)
    for a, b in zip(grads, grads_r):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5 * float(b.abs().max()))
    assert wk.LAUNCHES == {"wire_forward": 1, "wire_loss_grads": 1}


@pytest.mark.cuda
def test_wire_engine_adapters_on_card(card):
    """The engine's adapters launch the kernels and read omega/sigma from
    the params on the device (a moved omega changes the output)."""
    model, x, target = _wire(card, 500, 64, 2)
    params = model.params()
    apply = wk.make_wire_fused_apply(2)
    wk.reset_launches()
    base = apply(params, x)
    with torch.no_grad():
        params[-2] += 0.25
    moved = apply(params, x)
    assert not torch.allclose(base, moved)
    torch.testing.assert_close(moved, model(x), rtol=1e-4, atol=1e-6)
    loss, grads = wk.make_wire_value_and_grad(2)(params, x, target)
    assert len(grads) == len(params) and all(float(g) == 0 for g in grads[-6:])
    assert wk.LAUNCHES == {"wire_forward": 2, "wire_loss_grads": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout,padding", [
    ((2, 19, 35, 5, 16), 40, "SAME"), ((1, 3, 4, 3, 8), 8, "VALID"),
    ((3, 33, 17, 9, 32), 32, "VALID")])
def test_conv3d_launches_and_matches_plain(card, shape, cout, padding, dtype):
    """K6 launches once per call and agrees with its plain version: float32
    within 1e-5 of the largest output, bf16 within one bf16 ulp of each
    output (the float32 sums' order may round apart)."""
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen).to(card, dtype)
    k = (torch.randn((3, 3, 3, shape[-1], cout), generator=gen) * 0.1).to(card)
    b = torch.randn((cout,), generator=gen).to(card)
    ck.reset_launches()
    with torch.no_grad():
        out = ck.conv3d_rfab(x, k, b, padding)
    ref = ck.conv3d_rfab_ref(x, k, b, padding)
    assert ck.LAUNCHES == {"conv3d_rfab": 1} and out.dtype == dtype
    diff = (out.float() - ref.float()).abs()
    scale = float(ref.float().abs().max())
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-5 * scale
    else:
        ulp = 2.0 ** (torch.floor(torch.log2(ref.float().abs().clamp_min(1e-30))) - 7)
        assert bool((diff <= ulp + 1e-5 * scale).all())


@pytest.mark.cuda
def test_rams_on_k6_matches_cpu(card):
    """A small float32 RAMS with conv_kernel: 2 N + 1 + 3 (T // 3) K6
    launches on the card, the output within the RAMS class of the CPU's."""
    gen = torch.Generator().manual_seed(0)
    model = RAMS(filters=8, N=2, r=4, conv_kernel=True, generator=gen)
    x = torch.rand((2, 10, 12, 9), generator=gen) * 3000 + 6000
    with torch.inference_mode():
        cpu = model(x)
        ck.reset_launches()
        gpu = model.to(card)(x.to(card))
    assert ck.LAUNCHES == {"conv3d_rfab": 2 * 2 + 1 + 3 * 3}
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=2e-5, atol=2e-2)


@pytest.mark.cuda
def test_conv3d_refuses_gradients_on_card(card):
    x = torch.zeros(1, 4, 4, 3, 8, device=card, requires_grad=True)
    k, b = torch.zeros(3, 3, 3, 8, 8, device=card), torch.zeros(8, device=card)
    with pytest.raises(NotImplementedError, match="K7"):
        ck.conv3d_rfab(x, k, b)
    with pytest.raises(ValueError):
        ck.conv3d_rfab(x.detach(), k, b.cpu())
