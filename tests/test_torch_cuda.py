"""The port's CUDA kernels on the card. Every test here needs an NVIDIA GPU
and skips without one; the file imports neither JAX nor the JAX package, so
it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu_torch import set_float32_precision
from mri_super_resolution_tpu_torch.models import RAMS, Siren, SirenERD, Wire
from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck
from mri_super_resolution_tpu_torch.ops import mma_probe as mp
from mri_super_resolution_tpu_torch.ops import rams_gate as rg
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
    move) and agrees with its plain version, ragged rows and widths too; K1
    at these widths takes the SIMT route, and its launch code is held at the
    same shapes directly too."""
    x, ws, target, g = _problem(card, P=1000, dims=(64, 96, 130, 1))
    tk.reset_launches()
    torch.testing.assert_close(tk.siren_forward(x, ws), tk.siren_forward_ref(x, ws),
                               rtol=1e-4, atol=1e-6)
    loss_r, grads_r = tk.siren_loss_grads_ref(x, ws, target, n_rows=900)
    simt = tk._launch_loss_grads(tk._lib(), x, ws, target, 30.0, 900, 0)
    for loss, grads in (tk.siren_loss_grads(x, ws, target, n_rows=900), simt):
        torch.testing.assert_close(loss, loss_r, rtol=1e-4, atol=0)
        for a, b in zip(grads, grads_r):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-6)
    dx, dws = tk.siren_fused_bwd(x, ws, g)
    dx_r, dws_r = tk.siren_fused_bwd_ref(x, ws, g)
    torch.testing.assert_close(dx, dx_r, rtol=1e-3, atol=1e-8)
    for a, b in zip(dws, dws_r):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-8)
    assert tk.LAUNCHES == {**{k: 0 for k in tk.LAUNCHES}, "siren_forward": 1,
                           "siren_loss_grads": 1, "siren_fused_bwd": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dims,P,n_rows", [((256, 256, 256, 1), 1000, 900),
                                           ((128, 384, 128, 1), 777, 777)])
def test_k1_tc_route_launches_and_matches_plain(card, dims, P, n_rows):
    """K1 at widths of the tensor-core route's class launches once under
    its key (none on the SIMT route) and agrees with its plain version
    (bf16x3 products: each dW/db within 1e-4 of its largest magnitude); two
    calls give the same bits."""
    x, ws, target, _ = _problem(card, P=P, dims=dims)
    tk.reset_launches()
    loss, grads = tk.siren_loss_grads(x, ws, target, n_rows=n_rows)
    loss_r, grads_r = tk.siren_loss_grads_ref(x, ws, target, n_rows=n_rows)
    torch.testing.assert_close(loss, loss_r, rtol=1e-5, atol=0)
    for a, b in zip(grads, grads_r):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    loss2, grads2 = tk.siren_loss_grads(x, ws, target, n_rows=n_rows)
    assert torch.equal(loss, loss2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
    assert tk.LAUNCHES == {**{k: 0 for k in tk.LAUNCHES}, "siren_loss_grads_wg": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dims,P", [((256, 256, 256, 1), 1000), ((128, 384, 128, 1), 777),
                                    ((256, 128, 1), 300)])
def test_k2_k3_tc_route_launches_and_matches_plain(card, dims, P):
    """K3 and K2 (with and without dW) at widths of the tensor-core route's
    class launch under their ``*_wg`` keys (none on the SIMT route) and agree
    with their plain versions (bf16x3 products: the output, dx and each
    dW/db within 1e-4 of their largest magnitude); two calls give the same
    bits."""
    x, ws, _, g = _problem(card, P=P, dims=dims)
    tk.reset_launches()
    out = tk.siren_forward(x, ws)
    ref = tk.siren_forward_ref(x, ws)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert torch.equal(out, tk.siren_forward(x, ws))
    dx_r, grads_r = tk.siren_fused_bwd_ref(x, ws, g)
    for need_dw in (False, True):
        dx, grads = tk.siren_fused_bwd(x, ws, g, need_dw=need_dw)
        got, want = [dx, *(grads or [])], [dx_r, *(grads_r if need_dw else [])]
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
        dx2, grads2 = tk.siren_fused_bwd(x, ws, g, need_dw=need_dw)
        assert all(torch.equal(a, b) for a, b in zip(got, [dx2, *(grads2 or [])]))
    assert tk.LAUNCHES == {**{k: 0 for k in tk.LAUNCHES}, "siren_forward_wg": 2,
                           "siren_fused_bwd_wg": 4}


@pytest.mark.cuda
def test_autograd_function_on_the_tc_route(card):
    """siren_fused at a width of the route's class: K3 forward and K2
    backward on the tensor cores, gradients for x and the weights (K2 with
    dW) and for x alone (frozen weights, the PerturbNet step) against
    autograd through the plain forward."""
    x, ws, target, _ = _problem(card, P=777, dims=(128, 256, 256, 1))
    xr = x.clone().requires_grad_()
    wr = [w.clone().requires_grad_() for w in ws]
    gr = torch.autograd.grad(torch.mean((tk.siren_forward_ref(xr, wr) - target) ** 2),
                             [xr, *wr])
    tk.reset_launches()
    xk = x.clone().requires_grad_()
    wk = [w.clone().requires_grad_() for w in ws]
    gk = torch.autograd.grad(torch.mean((tk.siren_fused(xk, wk) - target) ** 2), [xk, *wk])
    for a, b in zip(gk, gr):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    (gx,) = torch.autograd.grad(torch.mean((tk.siren_fused(xk, ws) - target) ** 2), xk)
    assert float((gx - gr[0]).abs().max()) <= 1e-4 * float(gr[0].abs().max())
    assert tk.LAUNCHES == {**{k: 0 for k in tk.LAUNCHES}, "siren_forward_wg": 2,
                           "siren_fused_bwd_wg": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("weighted,absmax,n_rows", [(True, False, 1000), (False, True, 937),
                                                    (True, True, 999)])
def test_k1_variants_launch_and_match_plain(card, weighted, absmax, n_rows):
    """K1 with sample weights and/or max |out| on a SirenERD trunk (ReLU
    codes) launches once under its variant's key (the streaming route at
    these widths) and agrees with its plain version, and so does the SIMT
    K1 through its launch code; K3 and K2 with the same codes too."""
    gen = torch.Generator().manual_seed(7)
    model = SirenERD(2, 64, 2, generator=gen).to(card)
    with torch.no_grad():
        model.final.bias.fill_(0.05)  # an output that is not all zero
    ws, acts = [w.detach() for w in model.weights()], model.acts
    x = (torch.rand(1000, 2, generator=gen) * 2 - 1).to(card)
    t = torch.rand(1000, 1, generator=gen).to(card)
    sw = (torch.rand(1000, 1, generator=gen) * (torch.arange(1000) % 4 != 0)[:, None]).to(card)
    tk.reset_launches()
    got = tk.siren_loss_grads(x, ws, t, acts=acts, n_rows=n_rows,
                              sample_weights=sw if weighted else None,
                              with_out_absmax=absmax)
    want = tk.siren_loss_grads_ref(x, ws, t, 30.0, n_rows, acts, sw if weighted else None,
                                   absmax)
    simt = tk._launch_loss_grads(tk._lib(), x, ws, t, 30.0, n_rows, 0, acts,
                                 sw if weighted else None, absmax)
    for res in (got, simt):
        torch.testing.assert_close(res[0], want[0], rtol=1e-4, atol=0)
        if absmax:
            torch.testing.assert_close(res[1], want[1], rtol=1e-5, atol=0)
        for a, b in zip(res[-1], want[-1]):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-6)
    torch.testing.assert_close(tk.siren_forward(x, ws, acts=acts),
                               tk.siren_forward_ref(x, ws, acts=acts), rtol=1e-4, atol=1e-6)
    g = torch.randn(1000, 1, generator=gen).to(card) / 1000
    dx, dws = tk.siren_fused_bwd(x, ws, g, acts=acts)
    dx_r, dws_r = tk.siren_fused_bwd_ref(x, ws, g, acts=acts)
    for a, b in zip([dx, *dws], [dx_r, *dws_r]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-7)
    key = tk.loss_grads_key(weighted, absmax, "stream")
    assert tk.LAUNCHES == {**{k: 0 for k in tk.LAUNCHES}, key: 1, "siren_forward": 1,
                           "siren_fused_bwd": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("P,n_rows", [(3600, 3600), (3600, 3477), (4300, 4300)])
def test_k1_stream_route_at_the_ensemble_shape(card, P, n_rows):
    """K1-w at the 2-D ensemble's Siren 2 -> 64x7 -> 1, unbatched (and past
    32 row tiles of 128), launches once under its streaming key, agrees with
    its plain version within the SIMT route's bars, and repeats bit for
    bit."""
    gen = torch.Generator().manual_seed(P + n_rows)
    model = Siren(2, 64, 6, generator=gen).to(card)
    ws, acts = [w.detach() for w in model.weights()], model.acts
    x = (torch.rand(P, 2, generator=gen) * 2 - 1).to(card)
    t = (torch.rand(P, 1, generator=gen) * 2 - 1).to(card)
    sw = (torch.rand(P, 1, generator=gen) > 0.1).float().to(card)
    tk.reset_launches()
    loss, grads = tk.siren_loss_grads(x, ws, t, acts=acts, n_rows=n_rows, sample_weights=sw)
    loss_r, grads_r = tk.siren_loss_grads_ref(x, ws, t, 30.0, n_rows, acts, sw)
    torch.testing.assert_close(loss, loss_r, rtol=1e-4, atol=0)
    for a, b in zip(grads, grads_r):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-6)
    loss2, grads2 = tk.siren_loss_grads(x, ws, t, acts=acts, n_rows=n_rows, sample_weights=sw)
    assert torch.equal(loss, loss2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
    assert tk.LAUNCHES == {**{k: 0 for k in tk.LAUNCHES},
                           "siren_loss_grads_weighted_stream": 2}


@pytest.mark.cuda
def test_k1_absmax_takes_the_stream_route(card):
    """K1-a at the soft-ERD trunk's widths (about 270 KB of weights, more
    than one block's shared memory holds) takes the streaming tensor-core
    route."""
    gen = torch.Generator().manual_seed(3)
    model = SirenERD(2, 128, 3, generator=gen).to(card)
    ws, acts = [w.detach() for w in model.weights()], model.acts
    x = (torch.rand(500, 2, generator=gen) * 2 - 1).to(card)
    t = torch.rand(500, 1, generator=gen).to(card)
    tk.reset_launches()
    tk.siren_loss_grads(x, ws, t, acts=acts, with_out_absmax=True)
    assert tk.LAUNCHES == {**{k: 0 for k in tk.LAUNCHES}, "siren_loss_grads_absmax_stream": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("P,n_rows,weighted,last_bias", [
    (16384, 16384, False, 0.05),  # the soft-ERD fit's call
    (16384, 15150, True, 0.05),  # masked rows, sample weights
    (3000, 2999, False, 0.05),  # a ragged last tile
    (16384, 16384, False, -10.0),  # a collapsed output
])
def test_k1a_stream_route_at_the_soft_erd_shape(card, P, n_rows, weighted, last_bias):
    """K1-a on the streaming route at SirenERD(2, 128, 3) (2 -> 128x4 -> 128
    -> 1, ReLU codes, max |out|): the loss and max |out| within 1e-5
    relative of the plain version, each dW/db within 1e-3 of its largest
    magnitude (bf16x3 products); max |out| and every gradient exactly 0 on a
    collapsed output; bits that repeat; one launch a call under its key."""
    gen = torch.Generator().manual_seed(P + n_rows)
    model = SirenERD(2, 128, 3, generator=gen).to(card)
    with torch.no_grad():
        model.final.bias.fill_(last_bias)
    ws, acts = [w.detach() for w in model.weights()], model.acts
    x = (torch.rand(P, 2, generator=gen) * 2 - 1).to(card)
    t = torch.rand(P, 1, generator=gen).to(card)
    sw = (torch.rand(P, 1, generator=gen) > 0.1).float().to(card) if weighted else None
    tk.reset_launches()
    got = tk.siren_loss_grads(x, ws, t, acts=acts, n_rows=n_rows, sample_weights=sw,
                              with_out_absmax=True)
    again = tk.siren_loss_grads(x, ws, t, acts=acts, n_rows=n_rows, sample_weights=sw,
                                with_out_absmax=True)
    want = tk.siren_loss_grads_ref(x, ws, t, 30.0, n_rows, acts, sw, True)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    for a, b in zip(got[2], want[2]):
        assert float((a - b).abs().max()) <= 1e-3 * max(float(b.abs().max()), 1e-30)
    if last_bias < 0:
        assert float(got[1]) == 0.0 and all(float(g.abs().max()) == 0.0 for g in got[2])
    assert all(torch.equal(a, b) for a, b in zip(got[:2], again[:2]))
    assert all(torch.equal(a, b) for a, b in zip(got[2], again[2]))
    key = tk.loss_grads_key(weighted, True, "stream")
    assert tk.LAUNCHES == {**{k: 0 for k in tk.LAUNCHES}, key: 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_mma_probe_launches_and_matches_plain(card, dtype):
    """P1 (wgmma) at T 128, H 256, REPS 2, GRID 3 and GRID 1: int8 equal to
    the plain version, bf16 within float32 rounding of 512-term sums."""
    from mri_super_resolution_tpu_torch.cli.int8_mma_probe import operands

    a, b = (u.to(card) for u in operands(dtype, 128, 256, 2, seed=1))
    mp.reset_launches()
    for grid in (1, 3):
        out = mp.mma_probe(a, b, 2, grid)
        ref = mp.mma_probe_ref(a, b, 2, grid)
        if dtype == torch.int8:
            assert torch.equal(out, ref)
        else:
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4 * grid)
    assert mp.LAUNCHES[f"mma_probe_{mp.DTYPES[dtype]}"] == 2


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
    assert wk.LAUNCHES == {"wire_forward": 1, "wire_loss_grads": 1, "wire_loss_grads_tc": 0,
                           "wire_forward_tc": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("P,H,nh,n_rows", [(1000, 64, 2, 900), (777, 128, 1, 777),
                                           (3000, 256, 2, 2990)])
def test_wire_tc_route_launches_and_matches_plain(card, P, H, nh, n_rows):
    """K4 at a width of the tensor-core route's class launches once under
    its ``_tc`` key (none on the SIMT route), agrees with its plain version
    (bf16x3 products: the loss and each dW/db within 1e-3 of its largest
    magnitude, chip_smoke.py's K4_TOL) and repeats bit for bit."""
    model, x, target = _wire(card, P, H, nh)
    ws, _, oms = wk.split_params(model.params(), nh)
    wk.reset_launches()
    loss, grads = wk.wire_loss_grads(x, ws, oms, target, n_rows=n_rows)
    loss_r, grads_r = wk.wire_loss_grads_ref(x, ws, oms, target, n_rows=n_rows)
    for a, b in zip([loss, *grads], [loss_r, *grads_r]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
    loss2, grads2 = wk.wire_loss_grads(x, ws, oms, target, n_rows=n_rows)
    assert torch.equal(loss, loss2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
    assert wk.LAUNCHES == {"wire_forward": 0, "wire_loss_grads": 0, "wire_loss_grads_tc": 2,
                           "wire_forward_tc": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("P,H,nh", [(1000, 64, 2), (777, 128, 1), (17_856, 256, 2),
                                    (71_424, 256, 2), (262_144, 256, 2)])
def test_wire_forward_tc_route_launches_and_matches_plain(card, P, H, nh):
    """K5 at a width of the tensor-core route's class (the WIRE path's
    inference chunk and its tails among them) launches once under its
    ``_tc`` key (none on the SIMT route), agrees with its plain version
    within chip_smoke.py's K5_TOL of its largest magnitude and repeats bit
    for bit; through the engine's adapter it reads omega/sigma from the
    params on the device (a moved omega gives the plain version's moved
    output)."""
    model, x, _ = _wire(card, P, H, nh)
    ws, _, oms = wk.split_params(model.params(), nh)
    wk.reset_launches()
    out = wk.wire_forward(x, ws, oms)
    ref = wk.wire_forward_ref(x, ws, oms)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert torch.equal(out, wk.wire_forward(x, ws, oms))
    params = model.params()
    with torch.no_grad():
        params[-2] += 0.25
    moved = wk.make_wire_fused_apply(nh)(params, x)
    ref = wk.wire_forward_ref(x, ws, wk.split_params(params, nh)[2])
    assert float((moved - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert not torch.allclose(moved, out)
    assert wk.LAUNCHES == {"wire_forward": 0, "wire_loss_grads": 0, "wire_loss_grads_tc": 0,
                           "wire_forward_tc": 3}


@pytest.mark.cuda
@pytest.mark.parametrize("H,tc", [(64, True), (96, False)])
def test_wire_engine_adapters_on_card(card, H, tc):
    """The engine's adapters launch the kernels and read omega/sigma from
    the params on the device (a moved omega changes the output), against
    the nn.Module before and after the move. H = 64 takes the tensor-core
    route (K5 and K4 on ``wire_tc.cu``): its bf16x3 products are held to
    chip_smoke.py's K5_TOL, 1e-4 of max |model(x)|. H = 96 takes the SIMT
    kernels, held to the module element by element."""
    model, x, target = _wire(card, 500, H, 2)

    def check(out):
        want = model(x)
        if tc:
            assert float((out - want).abs().max()) <= 1e-4 * float(want.abs().max())
        else:
            torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-6)

    params = model.params()
    apply = wk.make_wire_fused_apply(2)
    wk.reset_launches()
    base = apply(params, x)
    check(base)
    with torch.no_grad():
        params[-2] += 0.25
    moved = apply(params, x)
    assert not torch.allclose(base, moved)
    check(moved)
    loss, grads = wk.make_wire_value_and_grad(2)(params, x, target)
    assert len(grads) == len(params) and all(float(g) == 0 for g in grads[-6:])
    if tc:
        assert wk.LAUNCHES == {"wire_forward": 0, "wire_loss_grads": 0,
                               "wire_loss_grads_tc": 1, "wire_forward_tc": 2}
    else:
        assert wk.LAUNCHES == {"wire_forward": 2, "wire_loss_grads": 1,
                               "wire_loss_grads_tc": 0, "wire_forward_tc": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout,padding", [
    ((2, 19, 35, 5, 16), 40, "SAME"), ((1, 3, 4, 3, 8), 8, "VALID"),
    ((3, 33, 17, 9, 32), 32, "VALID"),
    # the bfloat16 kernel's flat-plane tiling (tests/test_torch_cuda_emulated_conv3d.py):
    # C 40, 24, 8 and 64 (K padded to 16), a ragged last tile, 11 t-planes
    # through the three-plane ring, strips of 9 columns
    ((1, 23, 13, 4, 40), 16, "SAME"), ((2, 6, 9, 11, 24), 48, "SAME"),
    ((1, 40, 30, 5, 8), 8, "VALID"), ((1, 4, 20, 3, 64), 8, "SAME")])
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
    assert ck.LAUNCHES == {"conv3d_rfab": 1, "conv3d_rfab_bwd": 0}
    assert out.dtype == dtype
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
    assert ck.LAUNCHES == {"conv3d_rfab": 2 * 2 + 1 + 3 * 3, "conv3d_rfab_bwd": 0}
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=2e-5, atol=2e-2)


def _serving_rfab(card, seed: int):
    """A full-width RFAB (32 filters, r 8) on K6 with seeded weights at the
    committed checkpoint's scale, biases that keep the gate off 0.5."""
    gen = torch.Generator().manual_seed(seed)
    blk = RAMS(filters=32, N=1, conv_kernel=True, generator=gen).rfabs[0]
    with torch.no_grad():
        for conv in (blk.att0, blk.att1):
            conv.bias.uniform_(-1.0, 1.0, generator=gen)
    return blk.to(card).requires_grad_(False)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(25, 130, 130, 9, 32), (25, 132, 132, 5, 32)])
def test_rfab_gate_at_the_serving_shapes_matches_the_eager_chain(card, shape):
    """Under inference_mode a full-width bf16 RFAB at a body and a reduce
    shape of the 25-draw forward: G1's gate within one bf16 ulp of the eager
    chain's, its output bit for bit the eager chain's wherever the two gates
    agree, G1's apply pass given the eager gate bit for bit everywhere, two
    runs the same bits, one fused launch a call and none eager."""
    blk = _serving_rfab(card, seed=sum(shape))
    gen = torch.Generator().manual_seed(1)
    res = torch.randn(shape, generator=gen).to(card, torch.bfloat16)
    B, C = shape[0], shape[-1]
    with torch.inference_mode():
        x = blk.conv1(torch.relu(blk.conv0(res)))
        rg.reset_launches()
        fused = blk.gate_fused(x, res)
        again = blk.gate_fused(x, res)
        assert rg.LAUNCHES == {"rfab_gate": 2, "rfab_gate_eager": 0}
        eager = blk.gate_eager(x, res)
        att_e = torch.sigmoid(blk.att1(torch.relu(blk.att0(
            x.float().mean(dim=(1, 2, 3), keepdim=True))))).to(x.dtype).reshape(B, C)
        x3, r3 = x.reshape(B, -1, C), res.reshape(B, -1, C)
        work = torch.empty(rg.work_floats(*x3.shape), device=card)
        att_f = torch.empty(B, C, dtype=x.dtype, device=card)
        stream = torch.cuda.current_stream().cuda_stream
        rg._launch_att(rg._lib(), x3, *blk.gate_weights(), work, att_f, rg.SLOT_PIXELS, stream)
        given = torch.empty_like(x3)
        rg._launch_apply(rg._lib(), x3, att_e, r3, given, stream)
    assert torch.equal(fused, again)
    assert torch.equal(given.reshape(shape), eager)
    ulp = 2.0 ** (torch.floor(torch.log2(att_e.float().abs())) - 7)
    assert bool(((att_f.float() - att_e.float()).abs() <= ulp).all())
    same = (att_f == att_e).reshape(B, 1, 1, 1, C).expand(shape)
    assert float(same.float().mean()) > 0.5
    assert torch.equal(fused[same], eager[same])


@pytest.mark.cuda
def test_rams_forward_takes_the_fused_gate_only_without_grad(card, monkeypatch):
    """A full-width bf16 RAMS on K6 (12 body and 3 reduce RFABs): a forward
    under inference_mode runs 15 fused gates and no eager one, within the
    bf16 class of the same forward on the eager gates; a training forward
    and backward runs 15 eager gates and no fused one."""
    gen = torch.Generator().manual_seed(3)
    model = RAMS(filters=32, N=12, conv_kernel=True, compute_dtype="bfloat16",
                 generator=gen).to(card)
    x = (torch.rand((2, 16, 16, 9), generator=gen) * 3000 + 6000).to(card)
    rg.reset_launches()
    with torch.inference_mode():
        fused = model(x)
    assert rg.LAUNCHES == {"rfab_gate": 15, "rfab_gate_eager": 0}
    with monkeypatch.context() as m:
        m.setattr(rg, "fused_applies", lambda x: False)
        with torch.inference_mode():
            eager = model(x)
    scale = float(eager.abs().max())
    assert float((fused - eager).abs().max()) <= 2e-3 * scale
    rg.reset_launches()
    model(x).square().mean().backward()
    assert rg.LAUNCHES == {"rfab_gate": 0, "rfab_gate_eager": 15}


@pytest.mark.cuda
@pytest.mark.parametrize("layout,dtype", [("nhwtc", "bfloat16"), ("nthwc", "bfloat16"),
                                          ("nhwtc", "float32")])
def test_rams_on_the_library_convs_takes_the_fused_gate(card, monkeypatch, layout, dtype):
    """The cuDNN route (conv_kernel off) in both layouts and in float32:
    under inference_mode every RFAB (2 body, 3 reduce) runs G1 and none the
    eager chain, within the compute type's class of the same forward on the
    eager gates (G1's gate may round the other way in a last bit)."""
    gen = torch.Generator().manual_seed(5)
    model = RAMS(filters=32, N=2, conv_kernel=False, compute_dtype=dtype, layout=layout,
                 generator=gen).to(card)
    x = (torch.rand((2, 16, 16, 9), generator=gen) * 3000 + 6000).to(card)
    rg.reset_launches()
    with torch.inference_mode():
        fused = model(x)
    assert rg.LAUNCHES == {"rfab_gate": 2 + 3, "rfab_gate_eager": 0}
    with monkeypatch.context() as m:
        m.setattr(rg, "fused_applies", lambda x: False)
        with torch.inference_mode():
            eager = model(x)
    scale = float(eager.abs().max())
    tol = 2e-3 if dtype == "bfloat16" else 1e-5
    assert float((fused - eager).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_an_exported_rams_keeps_the_eager_gate(card, tmp_path):
    """``serve.export_rams`` under no_grad on the card traces the eager gate
    (a graph cannot hold G1's ctypes calls): no fused gate while tracing,
    and the artifact serves within the bf16 class of the live model, whose
    gates run G1."""
    from mri_super_resolution_tpu_torch import serve

    gen = torch.Generator().manual_seed(6)
    model = RAMS(filters=8, N=1, r=4, compute_dtype="bfloat16", generator=gen).to(card)
    model.requires_grad_(False)
    x = (torch.rand((3, 12, 12, 9), generator=gen) * 3000 + 6000).to(card)
    rg.reset_launches()
    with torch.no_grad():
        serve.export_rams(model, str(tmp_path), height=12, width=12, device=card)
    assert rg.LAUNCHES["rfab_gate"] == 0 and rg.LAUNCHES["rfab_gate_eager"] > 0
    with torch.inference_mode():
        live = model(x)
        served = serve.load(str(tmp_path), device=card)(x)
    assert rg.LAUNCHES["rfab_gate"] == 1 + 3
    assert float((served - live).abs().max()) <= 2e-3 * float(live.abs().max())


@pytest.mark.cuda
def test_conv3d_refuses_gradients_on_card(card):
    """What the kernels do not take is refused on the card; an input that
    needs a gradient is no longer refused: it runs K6, and K7 backward."""
    x = torch.zeros(1, 4, 4, 3, 8, device=card, requires_grad=True)
    k, b = torch.zeros(3, 3, 3, 8, 8, device=card), torch.zeros(8, device=card)
    with pytest.raises(ValueError):
        ck.conv3d_rfab(x.detach(), k, b.cpu())
    with pytest.raises(ValueError, match="g must be"):
        ck.conv3d_rfab_bwd(x.detach(), k, torch.zeros(1, 4, 4, 2, 8, device=card))
    ck.reset_launches()
    ck.conv3d_rfab(x, k, b).sum().backward()
    assert ck.LAUNCHES == {"conv3d_rfab": 1, "conv3d_rfab_bwd": 1}
    assert x.grad is not None and x.grad.shape == x.shape


def _bwd_problem(card, shape, cout, padding, dtype):
    gen = torch.Generator().manual_seed(sum(shape) + cout)
    x = torch.randn(shape, generator=gen).to(card, dtype)
    k = (torch.randn((3, 3, 3, shape[-1], cout), generator=gen) * 0.1).to(card)
    g = torch.randn((*ck.out_shape(shape, padding), cout), generator=gen).to(card, dtype)
    return x, k, g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout,padding", [
    ((2, 19, 35, 5, 16), 40, "SAME"), ((1, 3, 4, 3, 8), 8, "VALID"),
    ((3, 33, 17, 9, 32), 32, "VALID"), ((4, 34, 34, 9, 32), 32, "SAME"),
    # the bfloat16 kernels' tiling: dW input blocks of 32 and 8 channels,
    # dx of a VALID conv (g padded by 2), dx over 64 channels, two column
    # strips of dW, more work items than workspace slots
    ((1, 23, 13, 4, 40), 16, "SAME"), ((2, 9, 7, 6, 24), 40, "VALID"),
    ((1, 4, 20, 3, 16), 64, "SAME"), ((1, 3, 100, 3, 8), 8, "SAME"),
    ((6, 17, 17, 12, 8), 8, "SAME")])
def test_conv3d_bwd_launches_and_matches_plain(card, shape, cout, padding, dtype):
    """K7 launches once per call and agrees with its plain version: dW and
    db within 1e-4 of their largest entry (float32 sums over every output
    pixel in another order), dx as K6's output (float32 within 1e-5 of the
    largest, bf16 within one bf16 ulp)."""
    x, k, g = _bwd_problem(card, shape, cout, padding, dtype)
    ck.reset_launches()
    dx, dw, db = ck.conv3d_rfab_bwd(x, k, g, padding)
    dx_r, dw_r, db_r = ck.conv3d_rfab_bwd_ref(x, k, g, padding)
    assert ck.LAUNCHES["conv3d_rfab_bwd"] == 1 and dx.dtype == dtype
    for a, b in ((dw, dw_r), (db, db_r)):
        assert a.dtype == torch.float32
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    diff = (dx.float() - dx_r.float()).abs()
    scale = float(dx_r.float().abs().max())
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-5 * scale
    else:
        ulp = 2.0 ** (torch.floor(torch.log2(dx_r.float().abs().clamp_min(1e-30))) - 7)
        assert bool((diff <= ulp + 1e-5 * scale).all())


def _bf16_within_one_ulp(out, ref) -> bool:
    """chip_smoke.py's K6 bound: each bfloat16 output within one bf16 ulp of
    the plain version's, plus 1e-5 of the largest output."""
    diff = (out.float() - ref.float()).abs()
    ulp = 2.0 ** (torch.floor(torch.log2(ref.float().abs().clamp_min(1e-30))) - 7)
    return bool((diff <= ulp + 1e-5 * float(ref.float().abs().max())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,padding", [((25, 130, 130, 9, 32), "SAME"),
                                           ((25, 132, 132, 9, 32), "VALID")])
def test_conv3d_bf16_at_the_serving_shapes(card, shape, padding):
    """bfloat16 K6 at the MISR serving path's main SAME and VALID calls (25
    draws, filters 32) against its plain version at chip_smoke.py's
    tolerance, one launch a call."""
    x, k, _ = _bwd_problem(card, shape, 32, padding, torch.bfloat16)
    b = torch.randn(32, device=card) * 0.1
    ck.reset_launches()
    with torch.no_grad():
        out = ck.conv3d_rfab(x, k, b, padding)
    assert ck.LAUNCHES == {"conv3d_rfab": 1, "conv3d_rfab_bwd": 0}
    assert _bf16_within_one_ulp(out, ck.conv3d_rfab_ref(x, k, b, padding))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,padding", [((32, 34, 34, 9, 32), "SAME"),
                                           ((32, 36, 36, 9, 32), "VALID")])
def test_conv3d_bwd_bf16_at_the_training_shapes(card, shape, padding):
    """bfloat16 K7 at the training path's main SAME and VALID calls (batch
    32, filters 32) against its plain version at chip_smoke.py's tolerances
    (dx one bf16 ulp, dW and db 1e-5 of their largest entry); a second run
    gives the same bits (no float atomics)."""
    x, k, g = _bwd_problem(card, shape, 32, padding, torch.bfloat16)
    ck.reset_launches()
    got = ck.conv3d_rfab_bwd(x, k, g, padding)
    again = ck.conv3d_rfab_bwd(x, k, g, padding)
    assert ck.LAUNCHES == {"conv3d_rfab": 0, "conv3d_rfab_bwd": 2}
    dx_r, dw_r, db_r = ck.conv3d_rfab_bwd_ref(x, k, g, padding)
    assert _bf16_within_one_ulp(got[0], dx_r)
    for a, b in ((got[1], dw_r), (got[2], db_r)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert all(torch.equal(u, v) for u, v in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_trainable_conv_on_card_matches_plain_autograd(card, padding):
    """The autograd Function (K6 forward, K7 backward) gives the gradients
    of autograd through the plain K6, float32."""
    x, k, g = _bwd_problem(card, (2, 9, 11, 5, 16), 16, padding, torch.float32)
    b = torch.randn(16, device=card)
    leaves = [t.clone().requires_grad_() for t in (x, k, b)]
    ck.reset_launches()
    got = torch.autograd.grad(ck.conv3d_rfab_trainable(*leaves, padding), leaves, g)
    assert ck.LAUNCHES == {"conv3d_rfab": 1, "conv3d_rfab_bwd": 1}
    ref_leaves = [t.clone().requires_grad_() for t in (x, k, b)]
    want = torch.autograd.grad(ck.conv3d_rfab_ref(*ref_leaves, padding), ref_leaves, g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5 * float(w.abs().max()))


@pytest.mark.cuda
def test_tiny_train_step_on_card_matches_cpu(card, tmp_path):
    """One Trainer step of a small float32 RAMS with conv_kernel on the
    card (12 K6 + 12 K7 launches) against the same step on the CPU (plain
    versions): the loss and every gradient leaf within 1e-4 of its
    largest entry."""
    from mri_super_resolution_tpu_torch.config import TrainerConfig
    from mri_super_resolution_tpu_torch.fit.trainer import Trainer

    rng = np.random.default_rng(0)
    x = rng.uniform(6000, 9000, (4, 10, 10, 9)).astype(np.float32)
    y = rng.uniform(6000, 9000, (4, 30, 30, 1)).astype(np.float32)
    m = np.ones_like(y)
    grads, losses = {}, {}
    for device in ("cpu", card):
        model = RAMS(filters=8, N=1, r=4, conv_kernel=True,
                     generator=torch.Generator().manual_seed(1))
        tr = Trainer(model, TrainerConfig(batch_size=4, hr_size=30,
                                          checkpoint_dir=str(tmp_path / str(device))),
                     device=device)
        tr.init()
        ck.reset_launches()
        losses[str(device)] = float(tr.train_step([tr._batch(np.arange(4), x, y, m)])[0])
        grads[str(device)] = {k: p.grad.cpu() for k, p in tr.model.named_parameters()}
    assert ck.LAUNCHES == {"conv3d_rfab": 12, "conv3d_rfab_bwd": 12}
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    for k, g in grads["cpu"].items():
        torch.testing.assert_close(grads["cuda"][k], g, rtol=0,
                                   atol=1e-4 * float(g.abs().max()) + 1e-12, msg=k)


def _stacked_problem(card, D, P, dims, seed):
    probs = [_problem(card, P=P, dims=dims, seed=seed + s) for s in range(D)]
    ws = [torch.stack([p[1][i] for p in probs]) for i in range(len(probs[0][1]))]
    return probs[0][0], ws, torch.stack([p[2] for p in probs])


@pytest.mark.cuda
@pytest.mark.parametrize("dims,D,P,n_rows,key", [
    ((256, 256, 256, 1), 4, 1000, 900, "siren_loss_grads_wg_batched"),
    ((256, 256, 256, 1), 1, 777, 777, "siren_loss_grads_wg_batched"),
    ((2, 64, 64, 64, 1), 3, 3600, 3500, "siren_loss_grads_weighted_resident_tc_batched"),
])
def test_k1_batched_launches_and_matches_plain_and_unbatched(card, dims, D, P, n_rows, key):
    """The batched K1 launches once under its key for the D slots (stacked
    weights as a StackedAdam holds them, a parameter buffer's rows apart)
    and agrees with its plain batched version and with D unbatched calls;
    two calls give the same bits. The tensor-core class
    (``csrc/siren_wg.cu``) keeps the Pallas K1's bf16 stash: it is held to
    the plain version with that stash at 5e-4 of each grad's largest value,
    and to the float32 plain version and the unbatched calls by what the two
    stashes' plain versions part by plus 1e-3. The 2-D ensemble's class
    (``csrc/siren_resident_tc.cu``, bf16x3 products, the float32 stash)
    weighs its rows, slot D - 1 all zero (a padded acquisition slot: loss
    and grads exactly 0), and is held to the unbatched calls (the streaming
    route at these widths) as the tensor-core routes are, at 1e-3 of each
    grad's largest value."""
    from mri_super_resolution_tpu_torch.fit.optim import StackedAdam

    x, ws, target = _stacked_problem(card, D, P, dims, seed=P + D)
    ws = StackedAdam(ws, 1e-4).params
    sw = None
    if key.endswith("resident_tc_batched"):
        sw = (torch.rand(D, P, 1, generator=torch.Generator().manual_seed(D)) > 0.1).float()
        sw[-1] = 0.0
        sw = sw.to(card)
    tk.reset_launches()
    loss, grads = tk.siren_loss_grads_batched(x, ws, target, n_rows=n_rows, sample_weights=sw)
    assert tk.LAUNCHES == {**{k: 0 for k in tk.LAUNCHES}, key: 1}
    loss_r, grads_r = tk.siren_loss_grads_batched_ref(x, ws, target, n_rows=n_rows,
                                                      sample_weights=sw)
    torch.testing.assert_close(loss, loss_r, rtol=1e-4, atol=0)
    rel = lambda a, b: float((a - b).abs().max()) / float(b.abs().max())
    stash = [0.0] * len(grads)
    if key == "siren_loss_grads_wg_batched":
        _, grads_b = tk.siren_loss_grads_batched_ref(x, ws, target, n_rows=n_rows, stash="bf16")
        stash = [rel(b, f) for b, f in zip(grads_b, grads_r)]
        assert all(rel(a, b) <= 5e-4 for a, b in zip(grads, grads_b))
    for a, b, st in zip(grads, grads_r, stash):
        assert a.shape == b.shape
        assert rel(a, b) <= 1e-3 + st
    for s in range(D):
        ls, gs = tk.siren_loss_grads(x, [w[s] for w in ws], target[s], n_rows=n_rows,
                                     sample_weights=None if sw is None else sw[s])
        if key == "siren_loss_grads_wg_batched":
            torch.testing.assert_close(loss[s], ls, rtol=1e-4, atol=0)
            for a, b, st in zip(grads, gs, stash):
                assert rel(a[s], b) <= 1e-3 + st
        else:
            torch.testing.assert_close(loss[s], ls, rtol=1e-4, atol=0)
            for a, b in zip(grads, gs):  # the padded slot's are 0 on both sides
                assert float((a[s] - b).abs().max()) <= 1e-3 * float(b.abs().max())
    if sw is not None:
        assert float(loss[-1]) == 0.0 and all(float(g[-1].abs().max()) == 0.0 for g in grads)
    loss2, grads2 = tk.siren_loss_grads_batched(x, ws, target, n_rows=n_rows, sample_weights=sw)
    assert torch.equal(loss, loss2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))


@pytest.mark.cuda
def test_stacked_adam_on_the_card_matches_separate_adams(card):
    """Every slot stepping at one count, the stacked Adam divides by the
    same Python floats as Adam: from the same grads, the same bits on the
    card too, restarts included."""
    from mri_super_resolution_tpu_torch.fit.optim import Adam, StackedAdam

    _, ws, _ = _stacked_problem(card, 3, 10, (2, 64, 64, 1), seed=9)
    opt = StackedAdam(ws, 1e-3, restart_every=4)
    ref = [Adam([w[s].clone() for w in ws], 1e-3, restart_every=4) for s in range(3)]
    gen = torch.Generator(card).manual_seed(9)
    for _ in range(10):
        grads = [torch.randn(w.shape, generator=gen, device=card) for w in ws]
        opt.step(grads)
        for s, o in enumerate(ref):
            o.step([g[s] for g in grads])
    for s, o in enumerate(ref):
        assert all(torch.equal(a[s], b) for a, b in zip(opt.params, o.params))
