"""The port's CUDA kernels on the card. Every test here needs an NVIDIA GPU
and skips without one; the file imports neither JAX nor the JAX package, so
it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu_torch.ops import siren_kernel as tk


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
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
